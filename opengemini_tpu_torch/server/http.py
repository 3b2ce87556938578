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
                        the query_stages timings (the executor's, and
                        "encode": the answer's JSON and its write), and
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
                        (op=status|flush|invalidate|declare|drop) and
                        mod=obs (trace, hist, slow_ms, slow_max, clear)
  GET      /debug/slow  the slow-query log (utils/slowlog.py)
  GET      /debug/queries  the running queries (utils/querytracker.py
                        ``full_snapshot``)
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
  GET/POST /api/v1/rules, /api/v1/alerts: no rule manager runs in the
                        port yet (ROADMAP A7.2): empty groups and alerts
  POST     /api/v1/prom/write  Prometheus remote write (snappy prompb)
  POST     /api/v1/prom/read   Prometheus remote read (snappy answer)
  POST     /api/v1/otlp/metrics  OTLP/HTTP metrics (protobuf, gzip ok)
The resource governor (utils/governor.py) sheds /query, the PromQL
query routes and remote read with 503 and ``Retry-After`` when its
admission queue is full or its wait deadline passes, and /write,
/api/v2/write, remote write and OTLP with 429 and ``Retry-After`` while
the memtable and WAL backlog is over its high watermark; all of it is
pass-through while the governor is disabled.
Answers use the JAX server's JSON shapes, and error answers carry the
stable errno taxonomy (utils/errno.py: ``errno`` and ``module`` fields,
``X-Ogt-Errno`` header): a write while writes are disabled answers 403
with errno 2003. Other routes answer 404. A query whose scan meets a
damaged file answers as the reference's /query does: the file is
quarantined and the statement carries the error "file quarantined
after media fault: <path>: <why>" (query/executor.py); a retry answers
from the other files.
"""

from __future__ import annotations

import gzip
import json
import math
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from opengemini_tpu_torch import __version__
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


class HttpService:
    """Owns the HTTP listener; one Engine + Executor behind it. Port 0
    binds a free port (read it back from ``.port``)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8086,
                 prom_db: str = "prom"):
        self.engine = engine
        self.executor = Executor(engine)
        self.prom = PromEngine(engine)
        self.prom_db = prom_db
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
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

        def _params(self) -> dict:
            parsed = urllib.parse.urlparse(self.path)
            qs = urllib.parse.parse_qs(parsed.query)
            return {k: v[-1] for k, v in qs.items()}

        def _body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length) if length else b""
            if self.headers.get("Content-Encoding") == "gzip":
                data = gzip.decompress(data)
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

        def _observed(self, method: str, dispatch) -> None:
            """The endpoint latency histograms (http_request_seconds by
            route class and method); one flag read when histograms are
            off (OGT_TRACE=0)."""
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
            elif path.startswith("/api/v1/"):
                self._form_pairs = ()
                self._handle_prom(path, self._params())
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
            elif path.startswith("/api/v1/"):
                self._form_pairs = ()
                text = body.decode("utf-8", errors="replace")
                if text and self.headers.get("Content-Type", "").startswith(
                        "application/x-www-form-urlencoded"):
                    self._form_pairs = urllib.parse.parse_qsl(text)
                    for k, v in urllib.parse.parse_qs(text).items():
                        params.setdefault(k, v[-1])
                self._handle_prom(path, params)
            else:
                self._send_json(404, {"error": "not found"})

        # -- Prometheus HTTP API, remote write/read, OTLP ------------------

        def _handle_prom(self, path: str, params: dict):
            """Prometheus HTTP API v1 (reference: handler_prom.go). The
            query routes take an admission slot like /query; auth is not
            ported yet (ROADMAP A8)."""
            db = params.get("db", svc.prom_db)
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
                    # no rule manager runs in the port yet (ROADMAP
                    # A7.2): the reference's answer without one
                    data = {"groups": []}
                elif path == "/api/v1/alerts":
                    data = {"alerts": []}
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
            try:
                svc.engine.write_rows(db, points, rp=rp)
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
            if not db:
                self._send_json(400, {"error": "database is required"})
                return
            if self._shed_write_if_backpressured():
                return
            try:
                points = prom_remote.decode_write_request(
                    self._maybe_snappy(body))
            except (WireError, UnicodeDecodeError) as e:
                self._send_json(400, {"error": f"bad remote write body: {e}"})
                return
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
            if not db:
                self._send_json(400, {"error": "database is required"})
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
            offload planner, failpoints (utils/failpoint.py) and
            disk-fault rules (storage/diskfault.py)."""
            mod = params.get("mod", "")
            on = params.get("switchon", "").lower() in ("true", "1")
            if mod in ("disablewrite", "readonly"):
                svc.engine.write_disabled = on
            elif mod == "disableread":
                svc.engine.read_disabled = on
            elif mod == "flush":
                svc.engine.flush_all()
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
            q = params.get("q", "")
            if not q:
                self._send_json(400, {"error": "missing required parameter \"q\""})
                return
            try:
                result = svc.executor.execute(q, db=params.get("db", ""),
                                              read_only=read_only)
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
            if not db:
                self._send_json(400, {"error": "database is required"})
                return
            if self._shed_write_if_backpressured():
                return
            precision = params.get("precision", "ns")
            if precision == "n":
                precision = "ns"
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

    return Handler
