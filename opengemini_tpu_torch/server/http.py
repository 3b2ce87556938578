"""InfluxDB 1.x-compatible HTTP API, the routes of a single node.

The port of ``opengemini_tpu/server/http.py`` for these routes, on the
standard library's threading HTTP server:
  GET/HEAD /ping        204
  GET      /health      200 {"name", "status": "pass", "version"}
  GET/POST /query       InfluxQL, params q/db/epoch/pretty/chunked/
                        chunk_size (chunked: newline-delimited JSON, one
                        document per series or chunk_size rows, streamed
                        with Transfer-Encoding: chunked). A GET runs
                        SELECT, EXPLAIN and SHOW; other statements need
                        a POST (query/executor._is_readonly)
  POST     /write       line protocol, params db/rp/precision
  POST     /api/v2/write  the same, with bucket=<db>[/<rp>]
  GET      /metrics     every statistics counter, gauge and histogram in
                        the Prometheus text format (utils/stats.py
                        ``render_prometheus``), among them
                        ogt_http_request_seconds per route class and
                        method (``_route_of``)
  GET      /debug/vars  the statistics registry (utils/stats.py), with
                        the query_stages timings ("request": the
                        request's headers and parameters, the
                        executor's, and "encode": the answer's JSON and
                        its write), and
                        "quarantined_files": the engine's quarantined
                        TSF files ({shard, path, why} each)
  GET      /debug/device  device telemetry (utils/devobs.py
                        ``debug_doc``) and the offload planner's model
                        and decisions (query/offload.py, ``planner``)
  POST     /debug/ctrl  runtime switches (the reference's syscontrol):
                        mod=disablewrite|disableread|readonly
                        (switchon=true|false), mod=flush, mod=devobs
                        (arm, clear, op=mark_warm|clear_warm|profile
                        &seconds=&dir=), mod=offload (arm, freeze,
                        clear, force, host_kernels, min_samples,
                        explore_after, amortize, ewma, op=prewarm),
                        mod=failpoint (name, action; no name lists the
                        armed sites), mod=diskfault (path glob,
                        action; action=off clears one rule, clear=1
                        heals all, no action lists the rules and their
                        hits), mod=governor (budget_mb, max_concurrent,
                        queue, timeout_ms, hiwat_pct, lowat_pct,
                        overdraft_pct, bg_pause_pct, bg_max_pause_s,
                        bp_cache_ms; none = status), mod=rollup
                        (op=status|flush|invalidate|declare|drop),
                        mod=rules (op=status|declare|drop|tick: the
                        PromQL rule engine, promql/rules.py, built at
                        the first declare unless OGT_RULES=0),
                        mod=scrub (op=tick|purge, mb, interval_s: the
                        integrity scrub, services/scrub.py, with the
                        quarantined files), mod=durability (the
                        engine's acknowledged-against-durable ledger and
                        its violations) and mod=obs (trace, hist,
                        slow_ms, slow_max, clear)
  GET      /debug/slow  the slow-query log (utils/slowlog.py)
  GET      /api/v1/consume  cursor reads over a measurement (db,
                        measurement, cursor "t:k", limit)
  GET/POST/DELETE /repo/...  the log-mode surface (server/logstore.py:
                        repositories, logstreams, ndjson upload, logs,
                        histogram, context, analytics, consume)
  GET      /debug/queries  the running queries (utils/querytracker.py
                        ``full_snapshot``) with the engine's durability
                        ledger
  GET      /debug/trace the span tree of a query: ?qid= (a running
                        query's live tree, else the finished-trace
                        ring), ?trace_id=, or the newest summaries
  GET/POST /api/v1/query, /api/v1/query_range, /api/v1/labels,
                        /api/v1/series (repeated match[]),
                        /api/v1/label/<name>/values: the Prometheus HTTP
                        API over promql/engine.py (db defaults to
                        ``prom_db``; a form POST body counts like the
                        query string); 400 bad_data on a bad query,
                        422 canceled when KILL QUERY stops it
  GET/POST /api/v1/rules, /api/v1/alerts: the rule manager's groups
                        and pending or firing alerts (promql/rules.py;
                        empty while no manager runs)
  POST     /api/v1/prom/write  Prometheus remote write (snappy prompb)
  POST     /api/v1/prom/read   Prometheus remote read (snappy answer)
  POST     /api/v1/otlp/metrics  OTLP/HTTP metrics (protobuf, gzip ok)
and, clustered (``meta_store``, ``router`` set by whoever wires the
node; parallel/cluster.py, meta/service.py), the JAX server's
cluster routes with its bodies, so a node of either package serves the
other:
  POST     /raft/msg    a raft message for the meta store
  GET      /raft/status the meta store's status (credentials stripped)
  POST     /raft/join, /raft/remove  membership changes (leader only)
  GET      /cluster/health  this node's probe view (X-Ogt-Token)
  POST     /cluster/register, /cluster/deregister, /cluster/placement
                        roster and placement proposals (leader only)
  POST     /internal/write  structured points from a coordinator
  POST     /internal/select_meta, /internal/select_partials  the
                        aggregate pushdown (query/partials.py: the
                        partials computed on this engine's device)
  POST     /internal/scan, /internal/measurements, /internal/groups
                        raw columns (JSON or the binary wire), names
  POST     /internal/migrate  a two-phase migration's begin, write,
                        commit or abort (the engine's staging)
  POST     /internal/load, /internal/digest  this node's bytes by group
                        (the balancer), a group's content digest
                        (anti-entropy)
  POST     /internal/raftdata, /internal/raftdata_propose  strict
                        replication's raft messages and proposals
                        (parallel/datarep.py; 404 without it)
  POST     /debug/ctrl  mod=netfault (src, dst, path, action; clear=1)
                        and mod=cluster (probe_timeout_s, rpc_retries,
                        cb_threshold, cb_cooldown_s; op=migrate|balance|
                        move|hints|antientropy|health|add|drain|
                        decommission)
With a router, /write splits the body by shard-group owner
(``routed_write``, param ``consistency=any|one|quorum|all``). Every
/internal/* and /cluster/* body carries the cluster token
(``meta_store.token``). With ``auth_enabled`` the client routes take
Basic auth or u/p (meta/users.py): /query through the executor's
privilege checks (403), the writes WRITE and the PromQL routes READ on
their database (401 without a user); with no user yet only the first
admin's CREATE USER is open. ``tls`` ({"certfile", "keyfile"}) serves
every route over TLS, the handshake on the connection's thread.
The resource governor (utils/governor.py) sheds /query, the PromQL
query routes and remote read with 503 and ``Retry-After`` when its
admission queue is full or its wait deadline passes, and /write,
/api/v2/write, remote write and OTLP with 429 and ``Retry-After`` while
the memtable and WAL backlog is over its high watermark; all of it is
pass-through while the governor is disabled.
Answers use the JAX server's JSON shapes, and error answers carry the
stable errno taxonomy (utils/errno.py: ``errno`` and ``module`` fields,
``X-Ogt-Errno`` header): a write while writes are disabled answers 403
with errno 2003. A DELETE off /repo and every other route answer 404
JSON. A query whose scan meets a damaged file answers as the
reference's /query does: the file is quarantined and the statement carries the error "file quarantined
after media fault: <path>: <why>" (query/executor.py); a retry answers
from the other files.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import math
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from opengemini_tpu_torch import __version__
from opengemini_tpu_torch.meta.users import AuthError
from opengemini_tpu_torch.ingest.line_protocol import ParseError
from opengemini_tpu_torch.promql.engine import PromEngine, PromError
from opengemini_tpu_torch.promql.parser import PromParseError
from opengemini_tpu_torch.query import condition as cond
from opengemini_tpu_torch.query import offload
from opengemini_tpu_torch.query.executor import Executor
from opengemini_tpu_torch.record import FieldTypeConflict
from opengemini_tpu_torch.storage import diskfault
from opengemini_tpu_torch.storage.engine import NS as _NS
from opengemini_tpu_torch.storage.engine import DatabaseNotFound, WriteError
from opengemini_tpu_torch.storage.rollup import RollupSpec
from opengemini_tpu_torch.storage.rollup import enabled_by_env as rollup_enabled_by_env
from opengemini_tpu_torch.utils import devobs
from opengemini_tpu_torch.utils import errno as _errno
from opengemini_tpu_torch.utils import failpoint
from opengemini_tpu_torch.utils import stats as _stats
from opengemini_tpu_torch.utils import tracing
from opengemini_tpu_torch.utils.governor import GOVERNOR, AdmissionRejected
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER
from opengemini_tpu_torch.utils.querytracker import QueryKilled
from opengemini_tpu_torch.utils.slowlog import GLOBAL as SLOWLOG
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

_EPOCH_DIV = {"ns": 1, "u": 1_000, "µ": 1_000, "ms": 1_000_000,
              "s": 1_000_000_000, "m": 60_000_000_000,
              "h": 3_600_000_000_000}


def _route_of(path: str) -> str:
    """Coarse route class of the HTTP latency histograms: a fixed
    vocabulary, so /metrics label cardinality stays bounded whatever
    paths clients probe."""
    if path in ("/query",):
        return "query"
    if path in ("/write", "/api/v2/write"):
        return "write"
    if path in ("/api/v1/prom/write", "/api/v1/otlp/metrics"):
        return "write"
    if path.startswith("/api/v1/"):
        return "prom"
    if path.startswith("/internal/"):
        return "internal"
    if path.startswith("/debug/") or path == "/metrics":
        return "debug"
    if path.startswith("/raft/") or path.startswith("/cluster/"):
        return "cluster"
    if path == "/repo" or path.startswith("/repo/"):
        return "logstore"
    if path in ("/ping", "/health"):
        return "health"
    return "other"


def time_now_s() -> float:
    # wall clock: PromQL evaluation timestamp, not a duration
    return time.time()


def _prom_time(s: str | None) -> float:
    """Prom API time param: unix seconds (float) or RFC3339."""
    if s is None:
        raise ValueError("missing time parameter")
    try:
        return float(s)
    except ValueError:
        pass
    return cond.parse_rfc3339(s) / 1e9


def _prom_step(s: str | None) -> float:
    if s is None:
        raise ValueError("missing step parameter")
    try:
        return float(s)
    except ValueError:
        from opengemini_tpu_torch.promql.parser import parse_duration_s

        return parse_duration_s(s)


class _TLSThreadingServer(ThreadingHTTPServer):
    """The TLS handshake runs on the connection's own thread: accept()
    hands back the raw connection (do_handshake_on_connect=False), and
    finish_request, already on the per-connection thread, shakes hands
    with a bound, so one stalled client cannot block new connections."""

    def finish_request(self, request, client_address):
        import socket
        import ssl

        try:
            request.settimeout(30)
            request.do_handshake()
            request.settimeout(None)
        except (ssl.SSLError, OSError, socket.timeout):
            try:
                request.close()
            except OSError:
                pass
            return
        super().finish_request(request, client_address)


class HttpService:
    """Owns the HTTP listener; one Engine + Executor behind it. Port 0
    binds a free port (read it back from ``.port``)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8086,
                 prom_db: str = "prom", auth_enabled: bool = False,
                 tls: dict | None = None):
        self.engine = engine
        self.auth_enabled = auth_enabled
        self.executor = Executor(engine, auth_enabled=auth_enabled)
        self.users = self.executor.users
        self.prom = PromEngine(engine)
        self.prom_db = prom_db
        # clustered: the raft meta store and the data router, set by
        # whoever wires the node (the executor holds the same two)
        self.meta_store = None
        self.router = None
        # the rule manager (promql/rules.py) and the integrity scrub
        # (services/scrub.py): set by whoever starts them, or at the first
        # /debug/ctrl declare or scrub call
        self.rules_manager = None
        self.scrub_service = None
        self.flight = None  # FlightService when [flight] is configured
        from opengemini_tpu_torch.server.logstore import LogStoreAPI

        self.logstore = LogStoreAPI(self)  # the /repo log-mode surface
        # SHOW QUERIES and /debug/queries pair the running queries with
        # the engine's acknowledged-against-durable ledger
        TRACKER.set_durability_provider(engine.durability_snapshot)
        handler = _make_handler(self)
        if tls:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls["certfile"], tls["keyfile"])
            self.httpd = _TLSThreadingServer((host, port), handler)
            self.httpd.socket = ctx.wrap_socket(
                self.httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        else:
            self.httpd = ThreadingHTTPServer((host, port), handler)
        self.tls_enabled = bool(tls)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def format_result(result: dict, epoch: str | None) -> dict:
    """Convert internal ns times to the requested epoch, or RFC3339."""
    for res in result.get("results", []):
        for series in res.get("series", []):
            cols = series.get("columns", [])
            if not cols or cols[0] != "time":
                continue
            for row in series.get("values", []):
                t = row[0]
                if not isinstance(t, int):
                    continue
                if epoch:
                    row[0] = t // _EPOCH_DIV.get(epoch, 1)
                else:
                    row[0] = cond.format_rfc3339(t)
    return result


def _null_nonfinite(obj):
    """Deep-copy with non-finite floats replaced by None (influx marshals
    null)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _null_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_null_nonfinite(v) for v in obj]
    return obj


def _make_handler(svc: HttpService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "opengemini-tpu-torch/" + __version__
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            pass

        def parse_request(self):
            # the request line has arrived: a /query's "request" stage
            # runs from here to the executor (headers, route, parameters)
            self._t_request = time.perf_counter_ns()
            return super().parse_request()

        def _params(self) -> dict:
            parsed = urllib.parse.urlparse(self.path)
            qs = urllib.parse.parse_qs(parsed.query)
            return {k: v[-1] for k, v in qs.items()}

        def _body(self) -> bytes:
            """The request body, read once per request: a later call
            (the log store after the POST dispatch) gets the same
            bytes."""
            cached = getattr(self, "_body_cache", None)
            if cached is not None:
                return cached
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length) if length else b""
            if self.headers.get("Content-Encoding") == "gzip":
                data = gzip.decompress(data)
            self._body_cache = data
            return data

        def _send(self, code: int, payload: bytes = b"",
                  ctype: str = "application/json",
                  headers: dict | None = None):
            self.send_response(code)
            if payload:
                self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("X-Influxdb-Version", "1.8.0-" + __version__)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if payload:
                self.wfile.write(payload)

        def _send_json(self, code: int, obj: dict, pretty: bool = False,
                       headers: dict | None = None):
            indent = 4 if pretty else None
            try:
                data = json.dumps(obj, indent=indent, allow_nan=False) + "\n"
            except ValueError:
                data = json.dumps(_null_nonfinite(obj), indent=indent) + "\n"
            self._send(code, data.encode("utf-8"), headers=headers)

        def _send_err(self, status: int, exc: BaseException,
                      extra: dict | None = None):
            """Error answer with the stable errno taxonomy attached: the
            errno and module fields and the X-Ogt-Errno header."""
            code, mod = _errno.classify(exc)
            body = {"error": str(exc), "errno": code,
                    "module": mod.name.lower()}
            if extra:
                body.update(extra)
            self._send_json(status, body, headers={"X-Ogt-Errno": str(code)})

        def _authenticate(self, params: dict):
            """Basic auth or the u/p params (influx 1.x): the user, None
            when auth is off or no user exists yet (the bootstrap), or
            False after answering 401."""
            if not svc.auth_enabled or len(svc.users) == 0:
                return None
            import base64

            name = params.get("u")
            pw = params.get("p")
            header = self.headers.get("Authorization", "")
            if name is None and header.startswith("Basic "):
                try:
                    raw = base64.b64decode(header[6:]).decode("utf-8")
                    name, _, pw = raw.partition(":")
                except Exception:  # noqa: BLE001
                    name = None
            if name is None:
                self._send_json(401, {"error": "unable to parse "
                                               "authentication credentials"})
                return False
            try:
                return svc.users.authenticate(name, pw or "")
            except AuthError as e:
                self._send_err(401, e)
                return False

        def _check_write_auth(self, params: dict, db: str) -> bool:
            """WRITE on `db` (401 without a user, 403 without the
            privilege) and a database named; False after answering."""
            user = self._authenticate(params)
            if user is False:
                return False
            if svc.auth_enabled and not (user and user.can("WRITE", db)):
                self._send_json(401 if user is None else 403,
                                {"error": f"write not authorized on {db!r}"})
                return False
            if not db:
                self._send_json(400, {"error": "database is required"})
                return False
            return True

        def _check_read_auth(self, params: dict, db: str) -> bool:
            """READ on `db` for the PromQL routes; False after answering."""
            user = self._authenticate(params)
            if user is False:
                return False
            if svc.auth_enabled and not (user and user.can("READ", db)):
                self._send_json(401 if user is None else 403,
                                {"status": "error",
                                 "error": "read not authorized"})
                return False
            return True

        def _cluster_token_ok(self, sent, token=None) -> bool:
            """The shared cluster token (the meta store's, or `token`)
            vouches for a peer's call; with auth on and no token, peer
            routes are closed. Answers 403 and returns False on a
            refusal."""
            if token is None:
                token = (getattr(svc.meta_store, "token", "")
                         if svc.meta_store is not None else "")
            if token and sent != token:
                self._send_json(403, {"error": "bad cluster token"})
                return False
            if not token and svc.auth_enabled:
                self._send_json(403, {"error": "cluster token required"})
                return False
            return True

        def _internal_request(self, body: bytes) -> dict | None:
            """A peer's /internal/* body, parsed and its token checked;
            None after answering the refusal."""
            try:
                req = json.loads(body)
            except ValueError:
                req = None
            if not isinstance(req, dict) or not req.get("db"):
                self._send_json(400, {"error": "db required"})
                return None
            if not self._cluster_token_ok(req.get("token")):
                return None
            return req

        def _primary_filter(self, req):
            """rf > 1: serve only the groups this node is primary for
            among the caller's live set, so each counts once."""
            live = req.get("live")
            if (int(req.get("rf", 1)) > 1 and live
                    and svc.router is not None):
                return lambda sh: svc.router.is_primary(
                    req["db"], req.get("rp"), sh.tmin, live)
            return None

        def _not_leader(self) -> bool:
            """Answer 409 with the leader's id and address when this
            node is not the meta leader."""
            if svc.meta_store.is_leader():
                return False
            hint = svc.meta_store.leader_hint()
            self._send_json(409, {
                "error": "not the meta leader", "leader": hint,
                "leader_addr": svc.meta_store.meta_members().get(
                    hint or "", "")})
            return True

        def _send_chunked(self, result: dict, chunk_size: int):
            """Influx chunked answer: newline-delimited JSON documents,
            one per series (or per chunk_size rows of one), each
            serialized and written on its own with chunked transfer
            encoding."""
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Influxdb-Version", "1.8.0-" + __version__)
            self.end_headers()

            def emit(doc: dict) -> None:
                try:
                    text = json.dumps(doc, allow_nan=False)
                except ValueError:
                    text = json.dumps(_null_nonfinite(doc))
                data = (text + "\n").encode("utf-8")
                self.wfile.write(f"{len(data):X}\r\n".encode("ascii"))
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            for res in result.get("results", []):
                base = {k: v for k, v in res.items() if k != "series"}
                series_list = res.get("series", [])
                if not series_list:
                    emit({"results": [base]})
                    continue
                for series in series_list:
                    values = series.get("values", [])
                    for off in range(0, max(len(values), 1), chunk_size):
                        part = dict(series)
                        part["values"] = values[off:off + chunk_size]
                        if off + chunk_size < len(values):
                            part["partial"] = True
                        emit({"results": [dict(base, series=[part])]})
            self.wfile.write(b"0\r\n\r\n")

        def do_HEAD(self):
            if urllib.parse.urlparse(self.path).path == "/ping":
                self._send(204)
            else:
                self._send_json(404, {"error": "not found"})

        def do_GET(self):
            self._observed("GET", self._do_get)

        def do_POST(self):
            self._observed("POST", self._do_post)

        def do_DELETE(self):
            self._observed("DELETE", self._do_delete)

        def _observed(self, method: str, dispatch) -> None:
            """The endpoint latency histograms (http_request_seconds by
            route class and method); one flag read when histograms are
            off (OGT_TRACE=0)."""
            self._body_cache = None  # per request (keep-alive reuse)
            if not _stats.obs_enabled():
                dispatch()
                return
            t0 = time.perf_counter_ns()
            try:
                dispatch()
            finally:
                _stats.observe_ns(
                    "http_request_seconds", time.perf_counter_ns() - t0,
                    route=_route_of(urllib.parse.urlparse(self.path).path),
                    method=method)

        def _do_get(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/ping":
                self._send(204)
            elif path == "/health":
                self._send_json(200, {"name": "opengemini-tpu",
                                      "status": "pass",
                                      "version": __version__})
            elif path == "/query":
                self._handle_query(self._params(), read_only=True)
            elif path == "/debug/vars":
                snap = {"system": {
                    "uptime_s": round(time.perf_counter() - STATS.started_pc,
                                      1),
                    "version": __version__}}
                snap.update(STATS.snapshot())
                snap["quarantined_files"] = (
                    svc.engine.quarantine_snapshot()["files"])
                self._send_json(200, snap)
            elif path == "/metrics":
                self._send(
                    200, _stats.render_prometheus(__version__).encode("utf-8"),
                    ctype="text/plain; version=0.0.4; charset=utf-8")
            elif path == "/debug/queries":
                self._send_json(200, TRACKER.full_snapshot())
            elif path == "/debug/device":
                doc = devobs.debug_doc()
                doc["planner"] = offload.GLOBAL.debug_doc()
                self._send_json(200, doc)
            elif path == "/debug/trace":
                self._handle_debug_trace(self._params())
            elif path == "/debug/slow":
                self._send_json(200, SLOWLOG.snapshot())
            elif path == "/api/v1/consume":
                self._handle_consume(self._params())
            elif path == "/repo" or path.startswith("/repo/"):
                self._logstore("GET", path, self._params())
            elif path.startswith("/api/v1/"):
                self._form_pairs = ()
                self._handle_prom(path, self._params())
            elif path == "/raft/status" and svc.meta_store is not None:
                if self._authenticate(self._params()) is False:
                    return
                self._send_json(200, svc.meta_store.status())
            elif path == "/cluster/health" and svc.router is not None:
                # this node's probe view for the quorum failure view
                # (DataRouter.exchange_health), token-gated
                if not self._cluster_token_ok(
                        self.headers.get("X-Ogt-Token", ""),
                        getattr(svc.router, "token", "")):
                    return
                ts = svc.router.health_ts
                self._send_json(200, {
                    "id": svc.router.self_id,
                    "health": svc.router.health,
                    # the probe's relative age: the voters' staleness cut
                    # must not depend on the nodes' clocks agreeing
                    "age_s": (time.time() - ts) if ts else None,
                })
            else:
                self._send_json(404, {"error": "not found"})

        def _handle_debug_trace(self, params: dict) -> None:
            """?qid= serves one span tree (a RUNNING query's live tree,
            else the finished-trace ring); ?trace_id= looks up by trace
            id; bare = newest-first summaries."""
            qid_s = params.get("qid", "")
            if qid_s:
                try:
                    qid = int(qid_s)
                except ValueError:
                    self._send_json(400, {"error": f"bad qid {qid_s!r}"})
                    return
                live = TRACKER.trace_of(qid)
                if live is not None:
                    self._send_json(200, {
                        "qid": qid, "status": "running",
                        "trace_id": live.trace_id,
                        "trace": live.to_dict()})
                    return
                doc = tracing.get_trace(qid=qid)
                if doc is None:
                    self._send_json(
                        404, {"error": f"no trace for qid {qid} "
                              "(finished long ago, or OGT_TRACE off)"})
                    return
                self._send_json(200, dict(doc, status="finished"))
                return
            tid = params.get("trace_id", "")
            if tid:
                doc = tracing.get_trace(trace_id=tid)
                if doc is None:
                    self._send_json(404, {"error": f"no trace {tid!r}"})
                    return
                self._send_json(200, dict(doc, status="finished"))
                return
            self._send_json(200, {
                "enabled": tracing.trace_enabled(),
                "recent": tracing.recent_traces()})

        def _do_post(self):
            path = urllib.parse.urlparse(self.path).path
            params = self._params()
            body = self._body()
            if path == "/query":
                text = body.decode("utf-8", errors="replace")
                if text and self.headers.get("Content-Type", "").startswith(
                        "application/x-www-form-urlencoded"):
                    for k, v in urllib.parse.parse_qs(text).items():
                        params.setdefault(k, v[-1])
                self._handle_query(params)
            elif path == "/write":
                self._handle_write(params, params.get("db", ""),
                                   params.get("rp") or None, body)
            elif path == "/api/v2/write":
                db, _, rp = params.get("bucket", "").partition("/")
                self._handle_write(params, db, rp or None, body)
            elif path == "/debug/ctrl":
                self._handle_ctrl(params)
            elif path == "/ping":
                self._send(204)
            elif path == "/api/v1/prom/write":
                self._handle_prom_remote_write(params, body)
            elif path == "/api/v1/prom/read":
                self._handle_prom_remote_read(params, body)
            elif path == "/api/v1/otlp/metrics":
                self._handle_otlp_metrics(params, body)
            elif path == "/repo" or path.startswith("/repo/"):
                self._logstore("POST", path, params)
            elif path.startswith("/api/v1/"):
                self._form_pairs = ()
                text = body.decode("utf-8", errors="replace")
                if text and self.headers.get("Content-Type", "").startswith(
                        "application/x-www-form-urlencoded"):
                    self._form_pairs = urllib.parse.parse_qsl(text)
                    for k, v in urllib.parse.parse_qs(text).items():
                        params.setdefault(k, v[-1])
                self._handle_prom(path, params)
            elif path == "/raft/msg" and svc.meta_store is not None:
                self._handle_raft_msg(body)
            elif path == "/internal/write":
                self._handle_internal_write(body)
            elif path in ("/internal/select_meta",
                          "/internal/select_partials"):
                self._handle_internal_select(path, body)
            elif path == "/internal/groups":
                if self._internal_request(body) is None:
                    return
                self._send_json(200, {"groups": [
                    [db, rp, start]
                    for (db, rp, start) in sorted(svc.engine._shards)]})
            elif path in ("/internal/raftdata", "/internal/raftdata_propose"):
                self._handle_raftdata(path, body)
            elif path == "/internal/migrate":
                self._handle_internal_migrate(body)
            elif path == "/internal/load":
                # the balancer: this node's bytes by shard group
                if self._internal_request(body) is None:
                    return
                self._send_json(200, svc.engine.disk_usage())
            elif path == "/internal/digest":
                # anti-entropy: the content digest of one shard group here
                req = self._internal_request(body)
                if req is None:
                    return
                group = int(req.get("group_start", 0))
                digest: dict = {}
                for sh in svc.engine.shards_for_range(
                        req["db"], req.get("rp"), group, group + 1):
                    if sh.tmin == group:
                        digest = sh.content_digest()
                self._send_json(200, {"digest": digest})
            elif path in ("/internal/scan", "/internal/measurements"):
                self._handle_internal_scan(path, body)
            elif path in ("/cluster/register", "/cluster/deregister",
                          "/cluster/placement") \
                    and svc.meta_store is not None:
                self._handle_cluster_roster(path, body)
            elif path in ("/raft/join", "/raft/remove") \
                    and svc.meta_store is not None:
                self._handle_raft_conf(path, body)
            else:
                self._send_json(404, {"error": "not found"})

        # -- the cluster's routes ------------------------------------------

        def _handle_raft_msg(self, body: bytes) -> None:
            from opengemini_tpu_torch.meta.raft import RaftNode

            try:
                msg = json.loads(body)
            except ValueError:
                msg = None
            if not RaftNode.valid_message(msg):
                self._send_json(400, {"error": "bad raft message"})
                return
            token = getattr(svc.meta_store, "token", "")
            if token and msg.pop("token", None) != token:
                self._send_json(403, {"error": "bad cluster token"})
                return
            msg.pop("token", None)
            sender_addr = msg.pop("addr", None)
            if sender_addr:
                # learn the sender's address (its token checked): a
                # joiner must answer a leader it has never been told of
                addr_of = getattr(svc.meta_store.node.transport, "addr_of",
                                  None)
                if addr_of is not None:
                    addr_of[msg["from"]] = sender_addr
            svc.meta_store.node.deliver(msg)
            self._send(204)

        def _handle_raftdata(self, path: str, body: bytes) -> None:
            """Strict replication (parallel/datarep.py): a replica
            group's raft message, or a write proposed to a member. The
            replication's token vouches for the caller; 404 while the
            router runs without replication."""
            from opengemini_tpu_torch.meta.raft import RaftNode

            dr = getattr(svc.router, "datarep", None)
            if dr is None:
                self._send_json(404, {"error": "replication mode off"})
                return
            try:
                msg = json.loads(body)
            except ValueError:
                msg = None
            propose = path == "/internal/raftdata_propose"
            if not isinstance(msg, dict) or (propose and not msg.get("db")):
                self._send_json(400, {"error": "db required" if propose
                                      else "bad raft message"})
                return
            if not self._cluster_token_ok(msg.pop("token", None), dr.token):
                return
            if propose:
                self._send_json(200, dr.handle_propose(msg))
                return
            msg.pop("addr", None)
            core = {k: v for k, v in msg.items()
                    if k not in ("group", "owners")}
            if not RaftNode.valid_message(core):
                self._send_json(400, {"error": "bad raft message"})
                return
            dr.deliver(msg)
            self._send(204)

        def _handle_internal_migrate(self, body: bytes) -> None:
            """The two-phase migration's receiving side: begin opens an
            invisible staging area, write stages rows, commit folds them
            into the live shard (idempotent through its marker), abort
            drops the area (always ok: nothing staged means nothing to
            undo)."""
            from opengemini_tpu_torch.parallel.cluster import decode_points

            req = self._internal_request(body)
            if req is None:
                return
            op = req.get("phase")
            mig = str(req.get("mig_id", ""))
            try:
                if op == "begin":
                    failpoint.inject("internal-migrate-begin")
                    svc.engine.begin_staging(
                        req["db"], req.get("rp") or None,
                        int(req["group_start"]), mig)
                    out = {"ok": True}
                elif op == "write":
                    failpoint.inject("internal-migrate-write")
                    n = svc.engine.write_staging(
                        mig, decode_points(req.get("points", [])))
                    out = {"ok": True, "rows": n}
                elif op == "commit":
                    failpoint.inject("internal-migrate-commit")
                    out = {"ok": True,
                           "rows": svc.engine.commit_staging(mig)}
                    # folded and marked, the answer not yet sent: the
                    # pusher's retried commit reads the marker
                    failpoint.inject("internal-migrate-commit-before-reply")
                elif op == "abort":
                    failpoint.inject("internal-migrate-abort")
                    out = {"ok": True,
                           "aborted": svc.engine.abort_staging(mig)}
                else:
                    self._send_json(400, {"error": f"bad phase {op!r}"})
                    return
            except (KeyError, TypeError, ValueError) as e:
                self._send_json(400, {"error": f"bad migrate request: {e}"})
                return
            except WriteError as e:
                self._send_err(403, e)
                return
            self._send_json(200, out)

        def _handle_internal_write(self, body: bytes) -> None:
            """A coordinator's structured points for this replica, applied
            under a child span shipped back in the answer."""
            from opengemini_tpu_torch.parallel.cluster import (
                decode_points, write_points,
            )

            req = self._internal_request(body)
            if req is None:
                return
            # a shed here is transient for the coordinator: the copy is
            # hinted, never lost
            if self._shed_write_if_backpressured():
                return
            rtrace = tracing.start_remote(
                "internal_write", req.get("trace"),
                node=getattr(svc.router, "self_id", "") or "")
            failpoint.inject("internal-write-before-apply")
            try:
                points = decode_points(req.get("points", []))
                if rtrace is not None:
                    with tracing.activate(rtrace), \
                            rtrace.span("apply") as sp:
                        n_rows = write_points(svc.engine, req["db"], points,
                                              req.get("rp") or None)
                        sp.add_field("rows", n_rows)
                else:
                    write_points(svc.engine, req["db"], points,
                                 req.get("rp") or None)
            except DatabaseNotFound as e:
                # a replica behind on the meta plane: 404 keeps the copy
                # hinted until the database arrives
                self._send_err(404, e)
                return
            except (FieldTypeConflict, KeyError, TypeError,
                    ValueError) as e:
                self._send_json(400, {"error": f"bad points: {e}"})
                return
            except WriteError as e:
                # a deterministic refusal of this payload: 400 (poison to
                # the coordinator); 403 stays the token's
                self._send_err(400, e)
                return
            # durable here, but the answer may still die: the coordinator
            # then hints a duplicate (last-write-wins)
            failpoint.inject("internal-write-before-reply")
            out = {"ok": True}
            sub = tracing.ship_subtree(rtrace)
            if sub is not None:
                out["trace"] = sub
            self._send_json(200, out)

        def _handle_internal_select(self, path: str, body: bytes) -> None:
            """The pushdown's two rounds: the metadata of the measurement
            here, then the partials computed on this engine's device.
            Both take an admission slot (a 503 is PartialsUnavailable to
            the coordinator, not a dead node)."""
            from opengemini_tpu_torch.parallel.cluster import (
                serialize_select_meta,
            )
            from opengemini_tpu_torch.query.partials import compute_partials

            req = self._internal_request(body)
            if req is None:
                return
            try:
                with GOVERNOR.admitted():
                    if path == "/internal/select_meta":
                        self._send_json(200, serialize_select_meta(
                            svc.engine, req["db"], req.get("rp"),
                            req.get("mst", ""),
                            int(req.get("tmin", -(2**62))),
                            int(req.get("tmax", 2**62)),
                            shard_filter=self._primary_filter(req)))
                        return
                    try:
                        out = compute_partials(svc.engine, svc.router, req)
                    except (KeyError, TypeError, ValueError) as e:
                        self._send_json(
                            400, {"error": f"bad partials request: {e}"})
                        return
            except AdmissionRejected as e:
                self._send_json(
                    503, {"error": str(e)},
                    headers={"Retry-After": str(e.retry_after_s)})
                return
            self._send(200, out, ctype="application/octet-stream")

        def _handle_internal_scan(self, path: str, body: bytes) -> None:
            """Raw columns of a measurement for a coordinator (JSON, or
            the binary wire with fmt=bin), or its names here."""
            from opengemini_tpu_torch.parallel import cluster as pcluster
            from opengemini_tpu_torch.storage.shard import FileQuarantined

            req = self._internal_request(body)
            if req is None:
                return
            if path == "/internal/measurements":
                names = set()
                for sh in svc.engine.shards_for_range(
                        req["db"], req.get("rp"), -(2**62), 2**62):
                    names.update(sh.measurements())
                self._send_json(200, {"measurements": sorted(names)})
                return
            try:
                # the heaviest remote read: it takes an admission slot,
                # and a 503 is a clean error to the coordinator
                with GOVERNOR.admitted():
                    args = (svc.engine, req["db"], req.get("rp"),
                            req.get("mst", ""),
                            int(req.get("tmin", -(2**62))),
                            int(req.get("tmax", 2**62)))
                    kw = {"shard_filter": self._primary_filter(req),
                          "trace_ctx": req.get("trace"),
                          "node": getattr(svc.router, "self_id", "") or ""}
                    if req.get("fmt") == "bin":
                        out = pcluster.serialize_series_binary(*args, **kw)
                        self._send(200, out,
                                   ctype="application/octet-stream")
                        return
                    payload = pcluster.serialize_series(*args, **kw)
            except AdmissionRejected as e:
                self._send_json(
                    503, {"error": str(e)},
                    headers={"Retry-After": str(e.retry_after_s)})
                return
            except FileQuarantined as e:
                # quarantined mid-scan: a clean 500, and the coordinator
                # reads these groups from a replica this round
                self._send_err(500, e)
                return
            self._send_json(200, payload)

        def _handle_cluster_roster(self, path: str, body: bytes) -> None:
            """Register or deregister a data node, or place a group's
            owners: proposed on the meta leader (409 elsewhere)."""
            try:
                req = json.loads(body)
            except ValueError:
                req = None
            if not isinstance(req, dict):
                self._send_json(400, {"error": "json body required"})
                return
            if not self._cluster_token_ok(req.get("token")):
                return
            if self._not_leader():
                return
            if path == "/cluster/register":
                if not req.get("id") or not req.get("addr"):
                    self._send_json(400, {"error": "id and addr required"})
                    return
                cmd = {"op": "register_node", "id": req["id"],
                       "addr": req["addr"], "role": req.get("role", "data")}
            elif path == "/cluster/deregister":
                if not req.get("id"):
                    self._send_json(400, {"error": "id required"})
                    return
                cmd = {"op": "remove_node", "id": req["id"]}
            else:  # /cluster/placement
                owners_l = req.get("owners")
                if (not req.get("key") or not isinstance(owners_l, list)
                        or not owners_l
                        or not all(isinstance(o, str) for o in owners_l)):
                    self._send_json(400,
                                    {"error": "key and owners[] required"})
                    return
                cmd = {"op": "set_placement", "key": req["key"],
                       "owners": owners_l}
            ok = svc.meta_store.propose_and_wait(cmd)
            self._send_json(200 if ok else 503,
                            {"ok": True} if ok else {"error": "no quorum"})

        def _handle_raft_conf(self, path: str, body: bytes) -> None:
            """Add or remove a meta member (one change at a time, on the
            leader)."""
            try:
                req = json.loads(body)
            except ValueError:
                req = None
            if not isinstance(req, dict) or not req.get("id"):
                self._send_json(400, {"error": "id required"})
                return
            token = getattr(svc.meta_store, "token", "")
            if token and req.get("token") != token:
                self._send_json(403, {"error": "bad cluster token"})
                return
            if self._not_leader():
                return
            if path == "/raft/join":
                if not req.get("addr"):
                    self._send_json(400, {"error": "addr required"})
                    return
                ok = svc.meta_store.propose_conf_change(
                    "add", req["id"], req["addr"])
            else:
                ok = svc.meta_store.propose_conf_change("remove", req["id"])
            if ok:
                self._send_json(200, {"ok": True})
            else:
                self._send_json(503, {"error": "conf change failed"})

        # -- Prometheus HTTP API, remote write/read, OTLP ------------------

        def _handle_prom(self, path: str, params: dict):
            """Prometheus HTTP API v1 (reference: handler_prom.go). The
            query routes take an admission slot like /query; with auth on
            every route needs READ on its database."""
            db = params.get("db", svc.prom_db)
            if not self._check_read_auth(params, db):
                return
            try:
                if path == "/api/v1/query_range":
                    with GOVERNOR.admitted():
                        data = svc.prom.query_range(
                            params.get("query", ""),
                            _prom_time(params.get("start")),
                            _prom_time(params.get("end")),
                            _prom_step(params.get("step")),
                            db,
                        )
                elif path == "/api/v1/query":
                    t = params.get("time")
                    with GOVERNOR.admitted():
                        data = svc.prom.query_instant(
                            params.get("query", ""),
                            _prom_time(t) if t else time_now_s(),
                            db,
                        )
                elif path == "/api/v1/labels":
                    data = self._prom_labels(db)
                elif path == "/api/v1/series":
                    data = self._prom_series(db, params)
                elif (path.startswith("/api/v1/label/")
                      and path.endswith("/values")):
                    name = path[len("/api/v1/label/"):-len("/values")]
                    data = self._prom_label_values(db, name)
                elif path == "/api/v1/rules":
                    # empty groups, not 404, while no manager runs
                    mgr = svc.engine.rules_hook
                    data = (mgr.rules_api() if mgr is not None
                            else {"groups": []})
                elif path == "/api/v1/alerts":
                    mgr = svc.engine.rules_hook
                    data = (mgr.alerts_api() if mgr is not None
                            else {"alerts": []})
                else:
                    self._send_json(404, {"status": "error",
                                          "error": "not found"})
                    return
            except AdmissionRejected as e:
                self._send_json(
                    503, {"status": "error", "errorType": "unavailable",
                          "error": str(e)},
                    headers={"Retry-After": str(e.retry_after_s)})
                return
            except QueryKilled as e:
                # prom queries register with the query tracker, so KILL
                # QUERY cancels them like any /query statement
                self._send_json(
                    422, {"status": "error", "errorType": "canceled",
                          "error": str(e)})
                return
            except (PromError, PromParseError, ValueError, OverflowError,
                    re.error) as e:
                self._send_json(
                    400, {"status": "error", "errorType": "bad_data",
                          "error": str(e)})
                return
            t0 = time.perf_counter_ns()
            try:
                self._send_json(200, {"status": "success", "data": data})
            finally:
                # the answer's JSON and its write
                tracing.record_stage("encode", time.perf_counter_ns() - t0)

        def _prom_labels(self, db):
            names = {"__name__"}
            for sh in svc.engine.shards_for_range(db, None, -(2**62),
                                                  2**62):
                for mst in sh.measurements():
                    names.update(sh.index.tag_keys(mst))
            return sorted(names)

        def _prom_series(self, db, params):
            """/api/v1/series?match[]=selector — label sets of matching
            series, index-only. match[] may repeat; GET query string and
            POST form bodies both count."""
            from opengemini_tpu_torch.promql import parser as prom_parser

            parsed = urllib.parse.urlparse(self.path)
            matches = [v for k, v in urllib.parse.parse_qsl(parsed.query)
                       if k == "match[]"]
            matches += [v for k, v in getattr(self, "_form_pairs", ())
                        if k == "match[]"]
            if not matches:
                raise ValueError("missing match[] parameter")
            out = []
            seen = set()
            for expr_text in matches:
                expr = prom_parser.parse(expr_text)
                if not isinstance(expr, prom_parser.VectorSelector):
                    raise ValueError("match[] must be a vector selector")
                for labels in svc.prom.series_labels(expr, db):
                    key = tuple(sorted(labels.items()))
                    if key not in seen:
                        seen.add(key)
                        out.append(labels)
            return out

        def _prom_label_values(self, db, name):
            vals = set()
            for sh in svc.engine.shards_for_range(db, None, -(2**62),
                                                  2**62):
                for mst in sh.measurements():
                    if name == "__name__":
                        vals.add(mst)
                    else:
                        vals.update(sh.index.tag_values(mst, name))
            return sorted(vals)

        def _maybe_snappy(self, data: bytes) -> bytes:
            """Remote write/read bodies are snappy block compressed
            (Content-Encoding: snappy); tolerate raw protobuf too."""
            from opengemini_tpu_torch.ingest import protowire as pw

            if self.headers.get("Content-Encoding") == "snappy":
                return pw.snappy_uncompress(data)
            try:
                return pw.snappy_uncompress(data)
            except pw.WireError:
                return data

        def _write_decoded_points(self, db: str, rp, points) -> bool:
            """Write decoded points (or a ColumnarBatch: the engine's
            columnar path) and answer the error, if any."""
            try:
                if isinstance(points, list):
                    svc.engine.write_rows(db, points, rp=rp)
                else:
                    svc.engine.write_batch(db, points, rp=rp)
            except DatabaseNotFound as e:
                self._send_err(404, e)
                return False
            except (FieldTypeConflict, ValueError) as e:
                self._send_err(400, e, extra={"error": f"partial write: {e}"})
                return False
            except WriteError as e:
                self._send_err(403, e)
                return False
            return True

        def _handle_prom_remote_write(self, params: dict,
                                      body: bytes) -> None:
            """Prometheus remote write: snappy(protobuf WriteRequest)
            (reference: handler_prom.go:86 servePromWrite)."""
            from opengemini_tpu_torch.ingest import prom_remote
            from opengemini_tpu_torch.ingest.protowire import WireError

            db = params.get("db", "")
            if not self._check_write_auth(params, db):
                return
            if self._shed_write_if_backpressured():
                return
            try:
                series = prom_remote.decode_series(self._maybe_snappy(body))
            except (WireError, UnicodeDecodeError) as e:
                self._send_json(400, {"error": f"bad remote write body: {e}"})
                return
            # the columnar path; the points where a value or a key has no
            # line-protocol form
            points = (prom_remote.series_batch(series)
                      or prom_remote.series_points(series))
            if self._write_decoded_points(db, params.get("rp") or None,
                                          points):
                self._send(204)

        def _handle_prom_remote_read(self, params: dict,
                                     body: bytes) -> None:
            """Prometheus remote read: snappy(ReadRequest) ->
            snappy(ReadResponse) raw samples (reference: handler_prom.go
            servePromRead)."""
            from opengemini_tpu_torch.ingest import prom_remote
            from opengemini_tpu_torch.ingest import protowire as pw

            db = params.get("db", "")
            if not self._check_read_auth(params, db):
                return
            if not db:
                self._send_json(400, {"error": "database is required"})
                return
            try:
                queries = prom_remote.decode_read_request(
                    self._maybe_snappy(body))
            except pw.WireError as e:
                self._send_json(400, {"error": f"bad remote read body: {e}"})
                return
            try:
                # remote read materializes whole matched series: an
                # interactive read that takes an admission slot
                with GOVERNOR.admitted():
                    results = self._prom_remote_read_results(db, queries)
            except AdmissionRejected as e:
                self._send_json(
                    503, {"error": str(e)},
                    headers={"Retry-After": str(e.retry_after_s)})
                return
            out = pw.snappy_compress_literal(
                prom_remote.encode_read_response(results))
            self.send_response(200)
            self.send_header("Content-Type", "application/x-protobuf")
            self.send_header("Content-Encoding", "snappy")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def _prom_remote_read_results(self, db, queries) -> list:
            from opengemini_tpu_torch.ingest import prom_remote
            from opengemini_tpu_torch.promql.engine import _match_sids
            from opengemini_tpu_torch.promql.parser import LabelMatcher

            ms = 1_000_000
            results = []
            for q in queries:
                metric = ""
                matchers = []
                for op, name, value in q["matchers"]:
                    if name == "__name__" and op == "=":
                        metric = value
                    else:
                        matchers.append(LabelMatcher(name, op, value))
                series_out = []
                if metric:
                    tmin = q["start_ms"] * ms
                    tmax = q["end_ms"] * ms + 1
                    per_key: dict = {}
                    for sh in svc.engine.shards_for_range(db, None, tmin,
                                                          tmax):
                        for sid in sorted(_match_sids(
                                sh, metric, matchers, svc.engine.device)):
                            rec = sh.read_series(
                                metric, sid, tmin, tmax,
                                fields=[prom_remote.VALUE_FIELD])
                            col = rec.columns.get(prom_remote.VALUE_FIELD)
                            if col is None or not len(rec):
                                continue
                            tags = sh.index.tags_of(sid)
                            key = tuple(sorted(tags.items()))
                            bucket = per_key.setdefault(key,
                                                        (dict(tags), []))
                            v = col.valid
                            bucket[1].extend(
                                zip((rec.times[v] // ms).tolist(),
                                    col.values[v].tolist()))
                    for key in sorted(per_key):
                        labels, samples = per_key[key]
                        labels["__name__"] = metric
                        series_out.append((labels, sorted(samples)))
                results.append(series_out)
            return results

        def _handle_otlp_metrics(self, params: dict, body: bytes) -> None:
            """OTLP/HTTP metrics export (protobuf body, optional gzip)
            (reference: handler_otlp.go serveOtlpMetricsWrite)."""
            from opengemini_tpu_torch.ingest import otlp
            from opengemini_tpu_torch.ingest.protowire import WireError

            db = params.get("db", "")
            if not self._check_write_auth(params, db):
                return
            if self._shed_write_if_backpressured():
                return
            try:
                points = otlp.decode_metrics_request(body)
            except (WireError, UnicodeDecodeError) as e:
                self._send_json(400, {"error": f"bad OTLP body: {e}"})
                return
            if self._write_decoded_points(db, params.get("rp") or None,
                                          points):
                # an empty ExportMetricsServiceResponse
                self.send_response(200)
                self.send_header("Content-Type", "application/x-protobuf")
                self.send_header("Content-Length", "0")
                self.end_headers()

        def _handle_ctrl(self, params: dict):
            """The reference's /debug/ctrl switches: the engine's write
            and read switches and flush, device telemetry (devobs), the
            offload planner, failpoints (utils/failpoint.py), disk-fault
            rules (storage/diskfault.py), the rule engine, the integrity
            scrub and the durability ledger."""
            mod = params.get("mod", "")
            on = params.get("switchon", "").lower() in ("true", "1")
            if mod in ("disablewrite", "readonly"):
                svc.engine.write_disabled = on
            elif mod == "disableread":
                svc.engine.read_disabled = on
            elif mod == "flush":
                svc.engine.flush_all()
            elif mod == "durability":
                # one snapshot drives both fields, so the violations
                # always match the ledger reported beside them
                snap = svc.engine.durability_snapshot()
                violations = svc.engine.durability_check(snap)
                self._send_json(200, {
                    "status": "ok" if not violations else "violated",
                    "violations": violations, "durability": snap})
                return
            elif mod == "scrub":
                self._ctrl_scrub(params)
                return
            elif mod == "rules":
                self._ctrl_rules(params)
                return
            elif mod == "devobs":
                self._ctrl_devobs(params)
                return
            elif mod == "offload":
                self._ctrl_offload(params)
                return
            elif mod == "diskfault":
                self._ctrl_diskfault(params)
                return
            elif mod == "governor":
                self._ctrl_governor(params)
                return
            elif mod == "rollup":
                self._ctrl_rollup(params)
                return
            elif mod == "obs":
                self._ctrl_obs(params)
                return
            elif mod == "netfault":
                self._ctrl_netfault(params)
                return
            elif mod == "cluster":
                self._ctrl_cluster(params)
                return
            elif mod == "failpoint":
                name = params.get("name", "")
                action = params.get("action", "")
                if not name:
                    self._send_json(200, {"active": failpoint.active()})
                    return
                if action in ("", "off"):
                    failpoint.disable(name)
                else:
                    failpoint.enable(name, action)
                self._send_json(200, {"status": "ok", "failpoint": name,
                                      "action": action or "off"})
                return
            else:
                self._send_json(
                    400, {"error": f"unknown syscontrol mod {mod!r}"})
                return
            self._send_json(200, {"status": "ok", "mod": mod, "switchon": on})

        def _ctrl_netfault(self, params: dict):
            """The transport's fault rules for this process's outbound
            peer calls (parallel/netfault.py): no action lists them and
            their hits, action=off clears one, clear=1 heals all."""
            from opengemini_tpu_torch.parallel import netfault

            if params.get("clear", "").lower() in ("1", "true", "all"):
                netfault.clear_all()
                self._send_json(200, {"status": "ok", "rules": []})
                return
            action = params.get("action", "")
            if not action:
                self._send_json(200, {"rules": netfault.rules(),
                                      "hits": netfault.hits()})
                return
            src = params.get("src", "*")
            dst = params.get("dst", "*")
            pat = params.get("path", "*")
            if action == "off":
                netfault.clear_rule(src, dst, pat)
            else:
                try:
                    netfault.set_rule(src, dst, pat, action)
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
            self._send_json(200, {"status": "ok", "rules": netfault.rules()})

        def _ctrl_cluster(self, params: dict):
            """The router's RPC knobs and its synchronous rounds: migrate
            (after expiring staging older than staging_ttl_s), balance,
            move (db, dest), hints, antientropy, health, add (id, addr,
            role), drain and decommission (node: the forced removal of a
            dead peer; deadline_s)."""
            router = svc.router
            if router is None:
                self._send_json(400, {"error": "no data router"})
                return
            for key, conv in (("cb_threshold", int),
                              ("cb_cooldown_s", float),
                              ("probe_timeout_s", float),
                              ("rpc_retries", int)):
                if key not in params:
                    continue
                try:
                    val = conv(params[key])
                except ValueError:
                    self._send_json(
                        400, {"error": f"bad {key}={params[key]!r}"})
                    return
                # the constructor's clamps: a negative retry count would
                # run _post_raw's attempt loop zero times
                if key == "cb_threshold":
                    router.breaker.threshold = val
                elif key == "cb_cooldown_s":
                    router.breaker.cooldown_s = max(0.0, val)
                elif key == "rpc_retries":
                    router.rpc_retries = max(0, val)
                else:
                    router.probe_timeout_s = max(0.05, val)
            op = params.get("op", "")
            out: dict = {"status": "ok"}
            try:
                if op == "migrate":
                    out["expired"] = svc.engine.expire_staging(
                        float(params.get("staging_ttl_s", 900)))
                    out["moved"] = router.migrate_round()
                elif op == "balance":
                    out["move"] = router.balance_round()
                elif op == "move":
                    out["move"] = router.force_move(
                        params.get("db") or None,
                        dest=params.get("dest") or None)
                elif op == "hints":
                    out["delivered"] = router.replay_hints()
                elif op == "antientropy":
                    out["repaired"] = router.anti_entropy_round()
                elif op == "health":
                    out["health"] = router.exchange_health()
                elif op == "add":
                    out["add"] = router.add_node(
                        params.get("id", ""), params.get("addr", ""),
                        params.get("role", "data"))
                elif op == "drain":
                    out["drain"] = router.drain_round()
                elif op == "decommission":
                    out["decommission"] = router.decommission(
                        node=params.get("node") or None,
                        deadline_s=float(params.get("deadline_s", 60.0)))
                elif op:
                    self._send_json(
                        400, {"error": f"unknown cluster op {op!r}"})
                    return
            except Exception as e:  # noqa: BLE001 — report, never drop
                self._send_json(500, {"error": f"{op} failed: {e}"})
                return
            out["breaker"] = router.breaker.snapshot()
            out["staging"] = svc.engine.staging_ids()
            out["pending_hints"] = sorted(router.pending_hint_nodes())
            out["nodes"] = sorted(router.data_nodes())
            out["decommission_state"] = router.decommission_state
            self._send_json(200, out)

        def _ctrl_governor(self, params: dict):
            """Runtime tuning of the resource governor: each knob changes
            only when passed; no knob = status; budget_mb=0 disables."""
            knobs = {}
            for key in ("budget_mb", "max_concurrent", "queue",
                        "timeout_ms", "hiwat_pct", "lowat_pct",
                        "overdraft_pct", "bg_pause_pct",
                        "bg_max_pause_s", "bp_cache_ms"):
                if key in params:
                    try:
                        # the anti-starvation bound is a duration:
                        # fractional seconds mean something
                        knobs[key] = (float(params[key])
                                      if key == "bg_max_pause_s"
                                      else int(params[key]))
                    except ValueError:
                        self._send_json(
                            400, {"error": f"bad {key}={params[key]!r}"})
                        return
            if knobs:
                GOVERNOR.configure(**knobs)
            self._send_json(200, {"status": "ok",
                                  "governor": GOVERNOR.describe()})

        def _ctrl_rollup(self, params: dict):
            """Materialized-rollup operations (storage/rollup.py):
            (none)/status per-spec watermark and dirty windows;
            op=flush runs maintenance now; op=invalidate re-dirties
            [from, to) (everything when unset); op=declare declares a
            spec (db, name, measurement, every_s | every_ns, [fields,
            sketch, delay_s, rp]); op=drop drops one (db, name)."""
            op = params.get("op", "")
            mgr = svc.engine.rollup_mgr
            out = {"status": "ok", "enabled": rollup_enabled_by_env()}
            try:
                if op == "declare":
                    every_ns = (
                        int(params["every_ns"]) if "every_ns" in params
                        else int(float(params["every_s"]) * _NS))
                    fields = (params["fields"].split(",")
                              if params.get("fields") else None)
                    delay_ns = (int(float(params["delay_s"]) * _NS)
                                if "delay_s" in params else None)
                    spec = RollupSpec(
                        params["name"], params["measurement"], every_ns,
                        rp=params.get("rp") or None, fields=fields,
                        sketch=params.get("sketch", "1") not in
                        ("0", "false"),
                        delay_ns=delay_ns)
                    svc.engine.create_rollup(params["db"], spec)
                    mgr = svc.engine.rollup_mgr
                elif op == "drop":
                    svc.engine.drop_rollup(params["db"], params["name"])
                elif op == "flush":
                    if mgr is not None:
                        out["folded"] = mgr.maintain()
                elif op == "invalidate":
                    if mgr is not None:
                        out["invalidated"] = mgr.invalidate(
                            params["db"], params.get("name") or None,
                            int(params["from"]) if "from" in params
                            else None,
                            int(params["to"]) if "to" in params else None)
                elif op and op != "status":
                    self._send_json(
                        400, {"error": f"unknown rollup op {op!r}"})
                    return
            except KeyError as e:
                self._send_json(
                    400, {"error": f"missing parameter {e.args[0]!r}"})
                return
            except (ValueError, WriteError) as e:
                self._send_json(400, {"error": str(e)})
                return
            out["specs"] = mgr.status() if mgr is not None else {}
            self._send_json(200, out)

        def _ctrl_scrub(self, params: dict):
            """Integrity-scrub control (services/scrub.py): status and
            the quarantined files; op=tick sweeps once now, op=purge
            deletes the quarantined files, mb= and interval_s= set the
            pace. Without a scrub service of its own the server builds
            one for these calls."""
            from opengemini_tpu_torch.services.scrub import ScrubService

            scrub = svc.scrub_service
            if scrub is None:
                scrub = svc.scrub_service = ScrubService(svc.engine, 3600.0)
            # both knobs parse before either applies: a bad second one
            # rejects the whole request
            staged = []
            for key, conv, attr in (("mb", int, "mb_per_tick"),
                                    ("interval_s", float, "interval_s")):
                if key in params:
                    try:
                        val = conv(params[key])
                        if val <= 0:
                            raise ValueError(f"{key} must be > 0")
                    except ValueError as e:
                        self._send_json(400, {"error": str(e)})
                        return
                    staged.append((attr, val))
            for attr, val in staged:
                setattr(scrub, attr, val)
            out = {"status": "ok"}
            op = params.get("op", "")
            if op == "tick":
                out["verified_bytes"] = scrub.tick_now()
            elif op == "purge":
                out["purged_files"] = svc.engine.purge_quarantined()
            elif op:
                self._send_json(400, {"error": f"unknown op {op!r}"})
                return
            out["scrub"] = scrub.status()
            out["quarantine"] = svc.engine.quarantine_snapshot()
            self._send_json(200, out)

        def _ctrl_rules(self, params: dict):
            """The rule engine (promql/rules.py): (none)/status per-group
            watermark, alerts and tiles; op=declare a group (db, group,
            [interval_s, lateness_s]) and/or one rule (record=<name> |
            alert=<name>, expr, [for_s, labels, annotations as JSON]);
            op=drop a rule (db, group, name) or a group (db, group);
            op=tick evaluates the due groups now ([now_ns, db]). The
            manager is built at the first declare, unless OGT_RULES=0."""
            from opengemini_tpu_torch.promql.rules import (
                Rule, RuleError, RuleManager, enabled_by_env,
            )

            op = params.get("op", "")
            mgr = svc.engine.rules_hook
            out = {"status": "ok", "enabled": enabled_by_env()}
            try:
                if op == "declare":
                    if mgr is None and enabled_by_env():
                        mgr = svc.rules_manager = RuleManager(
                            svc.engine, prom=svc.prom)
                    if mgr is None:
                        self._send_json(
                            400, {"error": "rules disabled (OGT_RULES=0)"})
                        return
                    interval_s = (float(params["interval_s"])
                                  if "interval_s" in params else None)
                    lateness_s = (float(params["lateness_s"])
                                  if "lateness_s" in params else None)
                    if "record" in params or "alert" in params:
                        kind = ("recording" if "record" in params
                                else "alerting")
                        name = params.get("record") or params["alert"]
                        rule = Rule(
                            name, params["expr"], kind,
                            labels=(json.loads(params["labels"])
                                    if params.get("labels") else None),
                            for_s=float(params.get("for_s", 0.0)),
                            annotations=(json.loads(params["annotations"])
                                         if params.get("annotations")
                                         else None))
                        mgr.add_rule(params["db"], params["group"], rule,
                                     interval_s, lateness_s)
                    else:
                        mgr.declare_group(params["db"], params["group"],
                                          interval_s, lateness_s)
                elif op == "drop":
                    if mgr is None:
                        self._send_json(400, {"error": "no rule manager"})
                        return
                    if params.get("name"):
                        mgr.drop_rule(params["db"], params["group"],
                                      params["name"])
                    else:
                        mgr.drop_group(params["db"], params["group"])
                elif op == "tick":
                    if mgr is not None:
                        out["ticked"] = mgr.tick(
                            int(params["now_ns"]) if "now_ns" in params
                            else None,
                            db=params.get("db") or None)
                elif op and op != "status":
                    self._send_json(
                        400, {"error": f"unknown rules op {op!r}"})
                    return
            except KeyError as e:
                self._send_json(
                    400, {"error": f"missing parameter {e.args[0]!r}"})
                return
            except (RuleError, ValueError, WriteError) as e:
                self._send_json(400, {"error": str(e)})
                return
            out["groups"] = mgr.status() if mgr is not None else {}
            self._send_json(200, out)

        def _ctrl_obs(self, params: dict):
            """Observability tuning: trace capture on/off, histogram
            arming, the slow-query threshold and ring bound; no knob =
            status."""
            try:
                if "trace" in params:
                    tracing.set_trace_enabled(
                        params["trace"] in ("1", "true"))
                if "hist" in params:
                    _stats.set_obs_enabled(params["hist"] in ("1", "true"))
                if "slow_ms" in params:
                    v = params["slow_ms"]
                    # slow_ms= (empty) or slow_ms=off disables
                    SLOWLOG.configure(
                        slow_ms=None if v in ("", "off", "none")
                        else float(v))
                if "slow_max" in params:
                    SLOWLOG.configure(
                        slow_max=max(1, int(params["slow_max"])))
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            if params.get("clear", "") in ("1", "true"):
                SLOWLOG.clear()
                tracing.clear_recent()
            slow = SLOWLOG.snapshot()
            self._send_json(200, {
                "status": "ok",
                "trace": tracing.trace_enabled(),
                "hist": _stats.obs_enabled(),
                "slow_ms": slow["threshold_ms"],
                "slow_max": slow["max_records"],
                "slow_captured": slow["captured"],
            })

        def _ctrl_diskfault(self, params: dict):
            if params.get("clear", "").lower() in ("1", "true", "all"):
                diskfault.clear_all()
                self._send_json(200, {"status": "ok", "rules": []})
                return
            action = params.get("action", "")
            if not action:
                self._send_json(200, {"rules": diskfault.rules(),
                                      "hits": diskfault.hits()})
                return
            pat = params.get("path", "*")
            if action == "off":
                diskfault.clear_rule(pat)
            else:
                try:
                    diskfault.set_rule(pat, action)
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
            self._send_json(200, {"status": "ok",
                                  "rules": diskfault.rules()})

        def _ctrl_devobs(self, params: dict):
            """Arm/disarm, clear, the recompile tripwire and one
            torch.profiler capture at a time; no knob = status."""
            if "arm" in params:
                devobs.set_enabled(params["arm"] in ("1", "true"))
            if params.get("clear", "") in ("1", "true"):
                devobs.reset()
            op = params.get("op", "")
            if op == "mark_warm":
                devobs.mark_warm()
            elif op == "clear_warm":
                devobs.clear_warm()
            elif op == "profile":
                try:
                    seconds = float(params.get("seconds", "2"))
                except ValueError:
                    self._send_json(400, {
                        "error": f"bad seconds {params.get('seconds')!r}"})
                    return
                try:
                    started = devobs.start_profile(
                        seconds, logdir=params.get("dir") or None)
                except RuntimeError as e:
                    # a capture is active (or the profiler refused): 409,
                    # so retry loops back off instead of stacking
                    self._send_json(409, {"error": str(e)})
                    return
                self._send_json(200, {"status": "ok", "profile": started})
                return
            elif op:
                self._send_json(400, {"error": f"unknown devobs op {op!r}"})
                return
            self._send_json(200, {
                "status": "ok",
                "armed": devobs.enabled(),
                "compiles_since_warm": devobs.compiles_since_warm(),
                "ledger_bytes": devobs.LEDGER.total_bytes(),
                "profile": devobs.profile_status(),
            })

        def _ctrl_offload(self, params: dict):
            """Arm, freeze, clear, force and tune the planner, pin the
            PromQL host-kernels switch, run a pre-warm sweep; no knob =
            the planner's debug document."""
            if "arm" in params:
                offload.set_enabled(params["arm"] in ("1", "true"))
            if "freeze" in params:
                offload.GLOBAL.set_frozen(params["freeze"] in ("1", "true"))
            if params.get("clear", "") in ("1", "true"):
                offload.GLOBAL.clear()
            try:
                if "host_kernels" in params:
                    offload.set_prom_host_kernels_mode(params["host_kernels"])
                if "force" in params:
                    v = params["force"]
                    offload.set_force(None if v in ("", "none") else v)
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            knobs = {}
            for k, conv in (("min_samples", int), ("explore_after", int),
                            ("amortize", float), ("ewma", float)):
                if k in params:
                    try:
                        knobs[k] = conv(params[k])
                    except ValueError:
                        self._send_json(400,
                                        {"error": f"bad {k} {params[k]!r}"})
                        return
            if knobs:
                offload.GLOBAL.configure(**knobs)
            op = params.get("op", "")
            if op == "prewarm":
                self._send_json(200, {"status": "ok",
                                      "prewarmed": offload.prewarm_once()})
                return
            if op:
                self._send_json(400, {"error": f"unknown offload op {op!r}"})
                return
            doc = offload.GLOBAL.debug_doc()
            doc["status"] = "ok"
            self._send_json(200, doc)

        def _handle_query(self, params: dict, read_only: bool = False):
            user = self._authenticate(params)
            if user is False:
                return
            q = params.get("q", "")
            if not q:
                self._send_json(400, {"error": "missing required parameter \"q\""})
                return
            # the HTTP request's read and decode: the query stage before
            # the executor's "parse"
            tracing.record_stage("request",
                                 time.perf_counter_ns() - self._t_request)
            try:
                result = svc.executor.execute(q, db=params.get("db", ""),
                                              read_only=read_only, user=user)
            except AuthError as e:
                self._send_err(403, e)
                return
            except AdmissionRejected as e:
                # an admission shed: 503 with Retry-After, so clients back
                # off instead of retrying into the same overload
                self._send_json(
                    503, {"error": str(e)},
                    headers={"Retry-After": str(e.retry_after_s)})
                return
            t0 = time.perf_counter_ns()
            try:
                self._send_result(result, params)
            finally:
                # the answer's times, JSON and write: the query stage
                # after the executor's
                tracing.record_stage("encode", time.perf_counter_ns() - t0)

        def _send_result(self, result: dict, params: dict):
            result = format_result(result, params.get("epoch"))
            if params.get("chunked") in ("true", "1"):
                try:
                    chunk_size = max(1, int(params.get("chunk_size", 10_000)))
                except ValueError:
                    self._send_json(400, {"error": "bad chunk_size"})
                    return
                self._send_chunked(result, chunk_size)
                return
            self._send_json(200, result, params.get("pretty") in ("true", "1"))

        def _do_delete(self):
            path = urllib.parse.urlparse(self.path).path
            if path.startswith("/repo/"):
                self._logstore("DELETE", path, self._params())
            else:
                self._send_json(404, {"error": "not found"})

        def _handle_consume(self, params: dict):
            """Cursor reads over a measurement: GET /api/v1/consume?db=
            &measurement=&cursor=&limit=. The cursor "t:k" means every
            row before time t and k rows at t were taken (an exact resume
            across equal timestamps)."""
            user = self._authenticate(params)
            if user is False:
                return
            db = params.get("db", "")
            mst = params.get("measurement", "")
            if svc.auth_enabled and not (user and user.can("READ", db)):
                self._send_json(403, {"error": "read not authorized"})
                return
            if getattr(svc.engine, "read_disabled", False):
                self._send_json(
                    403, {"error": "reads are disabled (syscontrol)"})
                return
            if not db or not mst:
                self._send_json(
                    400, {"error": "db and measurement are required"})
                return
            try:
                limit = int(params.get("limit", 1000))
            except ValueError:
                self._send_json(400, {"error": "bad limit"})
                return
            limit = max(1, min(limit, 10_000))
            cursor = params.get("cursor", "")
            from_t, skip_at_t = 0, 0
            if cursor:
                try:
                    a, _, b = cursor.partition(":")
                    from_t, skip_at_t = int(a), int(b)
                except ValueError:
                    self._send_json(400, {"error": "bad cursor"})
                    return
            try:
                with GOVERNOR.admitted():  # a read like any other
                    rows, total = self._consume_gather(
                        db, mst, from_t, skip_at_t + limit)
            except AdmissionRejected as e:
                self._send_json(
                    503, {"error": str(e)},
                    headers={"Retry-After": str(e.retry_after_s)})
                return
            pos = 0
            remaining_skip = skip_at_t
            while (pos < len(rows) and rows[pos][0] == from_t
                   and remaining_skip > 0):
                pos += 1
                remaining_skip -= 1
            out = rows[pos:pos + limit]
            if out:
                last_t = out[-1][0]
                taken_at_last = sum(1 for r in out if r[0] == last_t)
                if last_t == from_t:
                    taken_at_last += skip_at_t - remaining_skip
                next_cursor = f"{last_t}:{taken_at_last}"
            else:
                next_cursor = cursor or "0:0"
            self._send_json(200, {
                "rows": [{"time": t, "tags": tags, "fields": fields}
                         for t, tags, fields in out],
                "cursor": next_cursor,
                "exhausted": (total - (skip_at_t - remaining_skip)
                              - len(out) <= 0),
            })

        def _consume_gather(self, db: str, mst: str, from_t: int,
                            need: int) -> tuple[list, int]:
            """One consume page: each series' rows from `from_t`, turned
            into Python rows only up to the `need`-th smallest time (ties
            included). Returns (rows by time, rows matched in all)."""
            from opengemini_tpu_torch.query.functions import py_value

            series_recs = []
            all_times = []
            for sh in svc.engine.shards_of_db(db):
                for sid in sorted(sh.index.series_ids(mst)):
                    rec = sh.read_series(mst, sid, from_t, 2**62)
                    if not len(rec):
                        continue
                    series_recs.append((sh.index.tags_of(sid), rec))
                    all_times.append(rec.times)
            total = sum(len(t) for t in all_times)
            page_tmax = None
            if total and need < total:
                merged = np.concatenate(all_times)
                page_tmax = int(np.partition(merged, need - 1)[need - 1])
            rows = []
            for tags, rec in series_recs:
                sel = (np.nonzero(rec.times <= page_tmax)[0]
                       if page_tmax is not None else range(len(rec)))
                for i in sel:
                    fields = {name: py_value(col.values[i])
                              for name, col in rec.columns.items()
                              if col.valid[i]}
                    rows.append((int(rec.times[i]), tags, fields))
            rows.sort(key=lambda r: r[0])
            return rows, total

        def _logstore(self, method: str, path: str, params: dict) -> None:
            """The /repo log-mode surface (server/logstore.py); its
            queries are admitted like /query's, so a shed answers 503
            with Retry-After."""
            try:
                handled = svc.logstore.handle(self, method, path, params)
            except AdmissionRejected as e:
                self._body()  # drain the unread body: keep-alive
                self._send_json(
                    503, {"error": str(e)},
                    headers={"Retry-After": str(e.retry_after_s)})
                return
            if not handled:
                self._send_json(404, {"error": "not found"})

        def _shed_write_if_backpressured(self) -> bool:
            """Write-path backpressure: while the memtable and WAL backlog
            is over the governor's high watermark, answer 429 with
            Retry-After (the body was read already). True when shed."""
            retry_after = GOVERNOR.write_backpressure()
            if retry_after is None:
                return False
            self._send_json(
                429,
                {"error": "write backpressure: memtable+WAL backlog over "
                          "the high watermark; retry later"},
                headers={"Retry-After": str(retry_after)})
            return True

        def _handle_write(self, params: dict, db: str, rp, body: bytes):
            internal = bool(self.headers.get("X-Ogt-Internal"))
            if internal:
                # a peer's forward: the cluster token vouches for it (the
                # coordinator authenticated the client)
                if not self._cluster_token_ok(
                        self.headers.get("X-Ogt-Token", "")):
                    return
                if not db:
                    self._send_json(400, {"error": "database is required"})
                    return
            elif not self._check_write_auth(params, db):
                return
            if self._shed_write_if_backpressured():
                return
            precision = params.get("precision", "ns")
            if precision == "n":
                precision = "ns"
            if svc.router is not None and not internal:
                self._routed_write(db, rp, body, precision,
                                   params.get("consistency"))
                return
            try:
                svc.engine.write_lines(db, body, precision=precision, rp=rp)
            except DatabaseNotFound as e:
                self._send_err(404, e)
                return
            except (ParseError, FieldTypeConflict, ValueError) as e:
                self._send_err(400, e, extra={"error": f"partial write: {e}"})
                return
            except WriteError as e:
                self._send_err(403, e)
                return
            self._send(204)

        def _routed_write(self, db: str, rp, body: bytes, precision: str,
                          consistency=None):
            """The coordinator's write: parse, then the router's
            routed_write (split by owner, the local slice written here,
            the rest forwarded as structured points). A write traced
            (OGT_TRACE=1) keeps its tree with the replicas' apply spans
            in the trace ring."""
            from opengemini_tpu_torch.ingest import native_lp
            from opengemini_tpu_torch.ingest.line_protocol import parse_lines
            from opengemini_tpu_torch.parallel.cluster import RemoteScanError

            if consistency is not None and consistency not in (
                    "any", "one", "quorum", "all"):
                self._send_json(400, {
                    "error": f"invalid consistency {consistency!r} "
                             "(any, one, quorum, all)"})
                return
            wtrace = None
            if tracing.trace_enabled():
                wtrace = tracing.Trace("write")
                wtrace.root.add_field("database", db)
            try:
                with (tracing.activate(wtrace) if wtrace is not None
                      else contextlib.nullcontext()):
                    now = time.time_ns()
                    # the native parser where it takes the body (the
                    # line parser's equal), else the line parser
                    batch = native_lp.parse_columnar(body, precision, now)
                    points = (batch.to_points() if batch is not None
                              else parse_lines(body, precision, now))
                    svc.router.routed_write(db, rp, points,
                                            consistency=consistency)
            except RemoteScanError as e:
                self._send_json(503, {"error": f"forward failed: {e}"})
                return
            except DatabaseNotFound as e:
                self._send_err(404, e)
                return
            except (ParseError, FieldTypeConflict, ValueError) as e:
                self._send_err(400, e, extra={"error": f"partial write: {e}"})
                return
            except WriteError as e:
                self._send_err(403, e)
                return
            except OSError as e:
                self._send_json(503, {"error": f"forward failed: {e}"})
                return
            finally:
                if wtrace is not None:
                    wtrace.finish()
                    tracing.note_finished(None, wtrace, {"database": db})
            self._send(204)

    return Handler
