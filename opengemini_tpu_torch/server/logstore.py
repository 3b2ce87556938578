"""Log-storage mode: repositories, logstreams, JSON log ingest, and
pipe-syntax log search over HTTP.

Reference surface: lib/util/lifted/influx/httpd/handler_logstore*.go —
repository/logstream CRUD (a repository is a database, a logstream is a
retention policy + measurement, handler_logstore.go:199-495), ndjson
upload with precision/mapping/log-tags (:1052 getLogWriteRequest, :1125
parseJson), PPL log query + histogram + context endpoints
(handler_logstore_query.go:277 serveQueryLog, :120 QueryParam), and
cursor-based consumption (handler_logstore_consume.go).

TPU-native mapping: logs are ordinary engine rows (tags + a ``content``
string field plus any structured fields), so the whole existing path
serves them — text-index-pruned scans for full-text terms (match() →
native/textindex.cpp sidecars), device-side window counts for
histograms, device aggregation for analytics. The PPL grammar
(sql/logparser.py) compiles onto InfluxQL and runs through the standard
executor; EXTRACT patterns and alias predicates run host-side over the
result page only.

Routes (all under ``/repo``)::

    POST   /repo/{repo}                          create repository
    GET    /repo                                 list repositories
    GET    /repo/{repo}                          show (logstreams)
    DELETE /repo/{repo}                          drop repository
    POST   /repo/{repo}/logstreams/{ls}          create logstream {"ttl": days}
    DELETE /repo/{repo}/logstreams/{ls}          drop logstream
    GET    /repo/{repo}/logstreams               list logstreams
    POST   .../logstreams/{ls}/upload            ndjson ingest
    GET    .../logstreams/{ls}/logs              PPL search (scroll cursor)
    GET    .../logstreams/{ls}/histogram         time-bucketed counts
    GET    .../logstreams/{ls}/context           rows around a timestamp
    GET    .../logstreams/{ls}/analytics         agg GROUP BY over logs
    GET    .../logstreams/{ls}/consume/logs      cursor consumption
    GET    .../logstreams/{ls}/consume/cursor-time

The port of ``opengemini_tpu/server/logstore.py``, whole, with its
imports rewritten.
"""

from __future__ import annotations

import json
import re
import time as _time
import urllib.parse

from opengemini_tpu_torch.ingest.line_protocol import FieldType
from opengemini_tpu_torch.sql import logparser
from opengemini_tpu_torch.storage.engine import DatabaseNotFound

from opengemini_tpu_torch.sql.lexer import parse_duration_ns as _parse_interval_ns

NS_PER_MS = 1_000_000
NS_PER_DAY = 86_400 * 10**9
_NAME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_-]{0,127}$")
_PRECISION = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000,
              "": 1_000_000}
_MAX_LIMIT = 1000


class LogStoreAPI:
    """Stateless handler collection; one instance per HttpService."""

    def __init__(self, svc):
        self.svc = svc

    # -- dispatch ------------------------------------------------------------

    def handle(self, h, method: str, path: str, params: dict) -> bool:
        """Route a /repo request. Returns False when the path is not ours
        (caller falls through to its 404)."""
        if path != "/repo" and not path.startswith("/repo/"):
            return False
        if method in ("POST", "DELETE"):
            # drain the request body up front (cached; see Handler._body):
            # several routes ignore their payload, and unread bytes would
            # desync the next request on a keep-alive connection
            h._body()
        parts = [urllib.parse.unquote(p) for p in path.split("/") if p][1:]
        # validate name segments up front: repo/logstream names are
        # interpolated into InfluxQL identifiers downstream, so anything
        # outside the create-time charset is rejected before it can reach
        # the executor (identifier injection)
        for seg in (parts[0:1] + parts[2:3]):
            if seg and not _NAME_RE.match(seg):
                h._send_json(400, {"error": "invalid repository/logstream name"})
                return True
        try:
            if not parts:
                if method == "GET":
                    self._list_repos(h, params)
                    return True
                return False
            repo = parts[0]
            if len(parts) == 1:
                self._repo_crud(h, method, repo, params)
                return True
            if parts[1] != "logstreams":
                h._send_json(404, {"error": "not found"})
                return True
            if len(parts) == 2:
                if method == "GET":
                    self._list_streams(h, repo, params)
                    return True
                return False
            ls = parts[2]
            if len(parts) == 3:
                self._stream_crud(h, method, repo, ls, params)
                return True
            action = parts[3]
            if len(parts) == 5 and action == "consume":
                action = "consume/" + parts[4]
            elif len(parts) != 4:
                h._send_json(404, {"error": "not found"})
                return True
            fn = {
                "upload": self._upload,
                "logs": self._query_logs,
                "histogram": self._histogram,
                "context": self._context,
                "analytics": self._analytics,
                "consume/logs": self._consume_logs,
                "consume/cursor-time": self._consume_cursor_time,
            }.get(action)
            if fn is None:
                h._send_json(404, {"error": "not found"})
                return True
            fn(h, method, repo, ls, params)
            return True
        except DatabaseNotFound as e:
            h._send_json(404, {"error": f"repository not found: {e}"})
            return True
        except logparser.LogParseError as e:
            h._send_json(400, {"error": f"bad log query: {e}"})
            return True
        except (ValueError, TypeError) as e:
            # bad numeric query params (from/to/limit/...) and kin
            h._send_json(400, {"error": f"bad request: {e}"})
            return True

    # -- auth helpers --------------------------------------------------------

    def _auth(self, h, params, need: str, db: str):
        """Returns the user, or None after sending an error response."""
        user = h._authenticate(params)
        if user is False:
            return None
        if self.svc.auth_enabled:
            if need == "ADMIN":
                if not (user and getattr(user, "admin", False)):
                    h._send_json(403, {"error": "admin required"})
                    return None
            elif not (user and user.can(need, db)):
                h._send_json(403, {"error": f"{need.lower()} not authorized"})
                return None
        return user or True

    # -- repository / logstream CRUD ----------------------------------------

    def _list_repos(self, h, params):
        if self._auth(h, params, "ADMIN", "") is None:
            return
        h._send_json(200, {"repositories": sorted(self.svc.engine.database_names())})

    def _repo_crud(self, h, method, repo, params):
        eng = self.svc.engine
        if method == "POST":
            if self._auth(h, params, "ADMIN", repo) is None:
                return
            if not _NAME_RE.match(repo):
                h._send_json(400, {"error": "invalid repository name"})
                return
            if repo in eng.database_names():
                h._send_json(400, {"error": "repository already exists"})
                return
            eng.create_database(repo)
            h._send_json(200, {"success": True})
        elif method == "DELETE":
            if self._auth(h, params, "ADMIN", repo) is None:
                return
            if repo not in eng.database_names():
                h._send_json(404, {"error": "repository not found"})
                return
            eng.drop_database(repo)
            h._send_json(200, {"success": True})
        elif method == "GET":
            if self._auth(h, params, "READ", repo) is None:
                return
            if repo not in eng.database_names():
                h._send_json(404, {"error": "repository not found"})
                return
            h._send_json(200, {"repository": repo,
                               "logstreams": self._streams_of(repo)})
        else:
            h._send_json(405, {"error": "method not allowed"})

    def _streams_of(self, repo) -> list[dict]:
        d = self.svc.engine.databases[repo]
        out = []
        for name, rp in sorted(d.rps.items()):
            if name == d.default_rp and name == "autogen":
                continue  # the implicit default RP is not a logstream
            out.append({
                "name": name,
                "ttl_days": rp.duration_ns // NS_PER_DAY if rp.duration_ns else 0,
            })
        return out

    def _list_streams(self, h, repo, params):
        if self._auth(h, params, "READ", repo) is None:
            return
        if repo not in self.svc.engine.database_names():
            h._send_json(404, {"error": "repository not found"})
            return
        h._send_json(200, {"logstreams": self._streams_of(repo)})

    def _stream_crud(self, h, method, repo, ls, params):
        eng = self.svc.engine
        if method == "POST":
            if self._auth(h, params, "ADMIN", repo) is None:
                return
            if not _NAME_RE.match(ls):
                h._send_json(400, {"error": "invalid logstream name"})
                return
            if repo not in eng.database_names():
                h._send_json(404, {"error": "repository not found"})
                return
            if ls in eng.databases[repo].rps:
                h._send_json(400, {"error": "logstream already exists"})
                return
            opts = {}
            body = h._body()
            if body:
                try:
                    opts = json.loads(body)
                except ValueError:
                    h._send_json(400, {"error": "bad options body"})
                    return
            ttl_days = int(opts.get("ttl", 0) or 0)
            eng.create_retention_policy(
                repo, ls, duration_ns=ttl_days * NS_PER_DAY
            )
            h._send_json(200, {"success": True})
        elif method == "DELETE":
            if self._auth(h, params, "ADMIN", repo) is None:
                return
            if (repo not in eng.database_names()
                    or ls not in eng.databases[repo].rps):
                h._send_json(404, {"error": "logstream not found"})
                return
            eng.drop_retention_policy(repo, ls)
            h._send_json(200, {"success": True})
        elif method == "GET":
            if self._auth(h, params, "READ", repo) is None:
                return
            if repo not in eng.database_names():
                h._send_json(404, {"error": "repository not found"})
                return
            for s in self._streams_of(repo):
                if s["name"] == ls:
                    h._send_json(200, s)
                    return
            h._send_json(404, {"error": "logstream not found"})
        else:
            h._send_json(405, {"error": "method not allowed"})

    # -- upload --------------------------------------------------------------

    def _upload(self, h, method, repo, ls, params):
        if method != "POST":
            h._send_json(405, {"error": "method not allowed"})
            return
        if self._auth(h, params, "WRITE", repo) is None:
            return
        eng = self.svc.engine
        if repo not in eng.database_names() or ls not in eng.databases[repo].rps:
            h._send_json(404, {"error": "logstream not found"})
            return
        precision = params.get("precision", "")
        mult = _PRECISION.get(precision)
        if mult is None:
            h._send_json(400, {"error": f"invalid precision {precision!r}"})
            return
        mapping = {"timestamp": "time", "discard": [], "tags": []}
        if params.get("mapping"):
            try:
                user_map = json.loads(params["mapping"])
                if not isinstance(user_map, dict):
                    raise ValueError("mapping must be an object")
                mapping.update(user_map)
            except ValueError as e:
                h._send_json(400, {"error": f"bad mapping: {e}"})
                return
        log_tags = {}
        hdr = h.headers.get("log-tags", "")
        if hdr:
            try:
                log_tags = json.loads(hdr)
                if not isinstance(log_tags, dict):
                    raise ValueError("log-tags must be a JSON object")
            except ValueError as e:
                h._send_json(400, {"error": f"bad log-tags header: {e}"})
                return
        body = h._body()
        if params.get("type", "") == "json_array":
            try:
                objs = json.loads(body)
                if not isinstance(objs, list):
                    raise ValueError("expected a JSON array")
            except ValueError as e:
                h._send_json(400, {"error": f"bad body: {e}"})
                return
        else:
            objs = []
            for line in body.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    objs.append(json.loads(line))
                except ValueError:
                    objs.append(line.decode("utf-8", "replace")
                                if isinstance(line, bytes) else line)
        # non-object entries (bare scalars, plain-text lines) become
        # content-only rows — a log file of bare lines must ingest the
        # same way whether or not the lines happen to parse as JSON
        objs = [
            o if isinstance(o, dict)
            else {"content": o if isinstance(o, str) else json.dumps(o)}
            for o in objs
        ]
        now_ns = _time.time_ns()
        ts_field = mapping["timestamp"]
        discard = set(mapping.get("discard") or [])
        tag_fields = set(mapping.get("tags") or [])
        points, failed = [], 0
        for obj in objs:
            if not isinstance(obj, dict):
                failed += 1
                continue
            t_ns = now_ns
            raw_t = obj.get(ts_field)
            if raw_t is not None:
                try:
                    # ints stay exact: routing through float would corrupt
                    # ns-precision epochs above 2^53
                    t_int = raw_t if isinstance(raw_t, int) else int(float(raw_t))
                    t_ns = t_int * mult
                except (TypeError, ValueError):
                    failed += 1
                    continue
            tags = dict(log_tags)
            fields = {}
            content_parts = []
            for k, v in obj.items():
                if k == ts_field or k in discard:
                    continue
                if k in tag_fields:
                    tags[k] = str(v)
                elif isinstance(v, bool):
                    fields[k] = (FieldType.BOOL, v)
                elif isinstance(v, (int, float)):
                    fields[k] = (FieldType.FLOAT, float(v))
                elif isinstance(v, str):
                    fields[k] = (FieldType.STRING, v)
                else:  # nested objects/arrays: flatten into content
                    content_parts.append(f"{k}={json.dumps(v, sort_keys=True)}")
            if "content" not in fields:
                # every log row carries content: full-text terms and
                # histogram counts key off it (reference default log schema,
                # handler_logstore.go getDefaultSchemaForLog)
                base = " ".join(content_parts)
                if not base:
                    base = json.dumps(
                        {k: v for k, v in obj.items() if k != ts_field},
                        sort_keys=True,
                    )
                fields["content"] = (FieldType.STRING, base)
            points.append((ls, tuple(sorted(tags.items())), t_ns, fields))
        if not points:
            h._send_json(400, {"error": "no valid log lines", "failed": failed})
            return
        if self.svc.router is not None:
            n = self.svc.router.routed_write(repo, ls, points)
        else:
            n = self.svc.engine.write_rows(repo, points, rp=ls)
        h._send_json(200, {"success": True, "written": n, "failed": failed})

    # -- query ---------------------------------------------------------------

    def _time_range(self, params) -> tuple[int, int]:
        """from/to in ms (reference QueryLogRequest), defaults last hour."""
        now_ms = _time.time_ns() // NS_PER_MS
        frm = int(params.get("from", now_ms - 3_600_000))
        to = int(params.get("to", now_ms))
        return frm * NS_PER_MS, to * NS_PER_MS

    def _run_select(self, h, repo, ls, where: str | None, tmin: int, tmax: int,
                    order_desc: bool, limit: int, user) -> list[dict] | None:
        """SELECT * over the logstream through the standard executor;
        returns row dicts (timestamp ns + tags + fields) or None after an
        error response."""
        conds = [f"time >= {tmin}", f"time < {tmax}"]
        if where:
            conds.append(where)
        q = (
            f'SELECT * FROM "{repo}"."{ls}"."{ls}" WHERE '
            + " AND ".join(conds)
            + " GROUP BY * ORDER BY time "
            + ("DESC" if order_desc else "ASC")
            + f" LIMIT {limit}"
        )
        res = self.svc.executor.execute(
            q, db=repo, user=None if user is True else user
        )
        stmt = res["results"][0]
        if "error" in stmt:
            h._send_json(400, {"error": stmt["error"]})
            return None
        rows = []
        for series in stmt.get("series", []):
            cols = series["columns"]
            tags = series.get("tags") or {}
            for vals in series["values"]:
                row = dict(tags)
                for c, v in zip(cols, vals):
                    if v is None:
                        continue
                    row["timestamp" if c == "time" else c] = v
                rows.append(row)
        rows.sort(key=lambda r: r.get("timestamp", 0), reverse=order_desc)
        return rows[:limit]

    def _query_logs(self, h, method, repo, ls, params):
        user = self._auth(h, params, "READ", repo)
        if user is None:
            return
        t0 = _time.perf_counter()
        lq = logparser.parse_log_query(params.get("q", ""))
        aliases = set(lq.aliases)
        where = logparser.to_influxql_where(lq.cond, aliases)
        tmin, tmax = self._time_range(params)
        limit = max(1, min(int(params.get("limit", 10)), _MAX_LIMIT))
        reverse = params.get("reverse", "true").lower() != "false"
        # scroll cursor: "<ns>:<k>" = k rows already served AT exactly <ns>
        skip_at, cur_t = 0, None
        scroll_id = params.get("scroll_id", "")
        if scroll_id:
            try:
                a, _, b = scroll_id.partition(":")
                cur_t, skip_at = int(a), int(b)
            except ValueError:
                h._send_json(400, {"error": "bad scroll_id"})
                return
            # a crafted skip component must not defeat the page cap (fetch
            # = limit + skip_at becomes the engine LIMIT below); ties at
            # one timestamp beyond 10x the max page size are not a thing
            # a legitimate cursor can produce
            if not (0 <= cur_t and 0 <= skip_at <= 10 * _MAX_LIMIT):
                h._send_json(400, {"error": "bad scroll_id"})
                return
            if reverse:
                tmax = min(tmax, cur_t + 1)  # inclusive of ties at cur_t
            else:
                tmin = max(tmin, cur_t)
        fetch = limit + skip_at
        fetched = self._run_select(h, repo, ls, where, tmin, tmax, reverse,
                                   fetch, user)
        if fetched is None:
            return
        page_full = len(fetched) >= fetch
        # drop already-served ties at the cursor time
        raw = fetched
        if cur_t is not None and skip_at:
            kept, dropped = [], 0
            for r in raw:
                if dropped < skip_at and r.get("timestamp") == cur_t:
                    dropped += 1
                    continue
                kept.append(r)
            raw = kept
        # EXTRACT + alias predicates run downstream of the engine page; the
        # scroll cursor tracks progress through the RAW stream so a page
        # whose rows are mostly filtered out still advances and never
        # terminates early (complete only when the engine page ran dry)
        logparser.apply_extract(lq.extract, raw)
        if aliases:
            pred = logparser.alias_row_filter(lq.cond, aliases)
            flt = [(i, r) for i, r in enumerate(raw) if pred(r)]
        else:
            flt = list(enumerate(raw))
        if len(flt) > limit:
            flt = flt[:limit]
            consumed = raw[: flt[-1][0] + 1]
            more = True
        else:
            consumed = raw
            more = page_full and bool(raw)
        rows = [r for _i, r in flt]
        if params.get("highlight", "").lower() == "true":
            terms = _fulltext_terms(lq.cond)
            for r in rows:
                r["highlight"] = [
                    t for t in terms
                    if t.lower() in str(r.get("content", "")).lower()
                ]
        next_scroll = ""
        if more and consumed:
            last_t = consumed[-1]["timestamp"]
            ties = sum(1 for r in consumed if r["timestamp"] == last_t)
            if cur_t == last_t:
                ties += skip_at
            next_scroll = f"{last_t}:{ties}"
        for r in rows:
            r["timestamp"] = r["timestamp"] // NS_PER_MS  # ms out, like from/to
        h._send_json(200, {
            "success": True,
            "logs": rows,
            "count": len(rows),
            "scroll_id": next_scroll,
            "complete_progress": 100 if not next_scroll else 0,
            "took_ms": round((_time.perf_counter() - t0) * 1000, 2),
        })

    def _histogram(self, h, method, repo, ls, params):
        user = self._auth(h, params, "READ", repo)
        if user is None:
            return
        lq = logparser.parse_log_query(params.get("q", ""))
        if lq.extract is not None:
            h._send_json(400, {"error": "EXTRACT is not supported in histograms"})
            return
        where = logparser.to_influxql_where(lq.cond)
        tmin, tmax = self._time_range(params)
        interval_ns = _parse_interval_ns(params.get("interval", "")) or max(
            (tmax - tmin) // 60, NS_PER_MS
        )
        # whole-ms interval: GROUP BY time() below is expressed in ms, so a
        # sub-ms remainder would make reported bucket bounds drift off the
        # engine's actual buckets
        interval_ns = max(interval_ns // NS_PER_MS, 1) * NS_PER_MS
        conds = [f"time >= {tmin}", f"time < {tmax}"]
        if where:
            conds.append(where)
        q = (
            f'SELECT count(content) FROM "{repo}"."{ls}"."{ls}" WHERE '
            + " AND ".join(conds)
            + f" GROUP BY time({interval_ns // NS_PER_MS}ms) fill(0)"
        )
        res = self.svc.executor.execute(
            q, db=repo, user=None if user is True else user
        )
        stmt = res["results"][0]
        if "error" in stmt:
            h._send_json(400, {"error": stmt["error"]})
            return
        buckets, total = [], 0
        for series in stmt.get("series", []):
            for t_ns, cnt in series["values"]:
                cnt = int(cnt or 0)
                total += cnt
                buckets.append({
                    "from": t_ns // NS_PER_MS,
                    "to": (t_ns + interval_ns) // NS_PER_MS,
                    "count": cnt,
                })
        h._send_json(200, {"success": True, "histograms": buckets,
                           "count": total})

    def _context(self, h, method, repo, ls, params):
        """Rows surrounding a timestamp (reference serveContextQueryLog)."""
        user = self._auth(h, params, "READ", repo)
        if user is None:
            return
        lq = logparser.parse_log_query(params.get("q", ""))
        aliases = set(lq.aliases)
        where = logparser.to_influxql_where(lq.cond, aliases)
        try:
            ts_ms = int(params["timestamp"])
        except (KeyError, ValueError):
            h._send_json(400, {"error": "timestamp (ms) is required"})
            return
        back = max(0, min(int(params.get("backward", 10)), _MAX_LIMIT))
        fwd = max(0, min(int(params.get("forward", 10)), _MAX_LIMIT))
        ts_ns = ts_ms * NS_PER_MS
        tmin, tmax = self._time_range(params)
        before = self._run_select(h, repo, ls, where, tmin, ts_ns, True,
                                  back, user) if back else []
        if before is None:
            return
        after = self._run_select(h, repo, ls, where, ts_ns, tmax, False,
                                 fwd, user) if fwd else []
        if after is None:
            return
        rows = list(reversed(before)) + after
        logparser.apply_extract(lq.extract, rows)
        if aliases:
            pred = logparser.alias_row_filter(lq.cond, aliases)
            rows = [r for r in rows if pred(r)]
        for r in rows:
            r["timestamp"] = r["timestamp"] // NS_PER_MS
        h._send_json(200, {"success": True, "logs": rows, "count": len(rows)})

    def _analytics(self, h, method, repo, ls, params):
        """Aggregated view over logs: count/sum/mean/min/max of a field,
        grouped by a tag and/or time buckets — the device aggregation path
        (reference serveAnalytics / serveAggLogQuery)."""
        user = self._auth(h, params, "READ", repo)
        if user is None:
            return
        lq = logparser.parse_log_query(params.get("q", ""))
        if lq.extract is not None:
            h._send_json(400, {"error": "EXTRACT is not supported in analytics"})
            return
        where = logparser.to_influxql_where(lq.cond)
        tmin, tmax = self._time_range(params)
        agg = params.get("agg", "count").lower()
        if agg not in ("count", "sum", "mean", "min", "max"):
            h._send_json(400, {"error": f"unsupported agg {agg!r}"})
            return
        field = params.get("field", "content" if agg == "count" else "")
        if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", field or ""):
            h._send_json(400, {"error": "field is required"})
            return
        groups = []
        group_by = params.get("group_by", "")
        if group_by:
            if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", group_by):
                h._send_json(400, {"error": "bad group_by"})
                return
            groups.append(f'"{group_by}"')
        interval_ns = _parse_interval_ns(params.get("interval", ""))
        if interval_ns:
            groups.append(f"time({interval_ns // NS_PER_MS}ms)")
        conds = [f"time >= {tmin}", f"time < {tmax}"]
        if where:
            conds.append(where)
        q = (
            f'SELECT {agg}("{field}") FROM "{repo}"."{ls}"."{ls}" WHERE '
            + " AND ".join(conds)
            + (" GROUP BY " + ", ".join(groups) if groups else "")
        )
        res = self.svc.executor.execute(
            q, db=repo, user=None if user is True else user
        )
        stmt = res["results"][0]
        if "error" in stmt:
            h._send_json(400, {"error": stmt["error"]})
            return
        out = []
        for series in stmt.get("series", []):
            tags = series.get("tags") or {}
            for vals in series["values"]:
                t_ns, v = vals[0], vals[1]
                row = dict(tags)
                if interval_ns:
                    row["from"] = t_ns // NS_PER_MS
                    row["to"] = (t_ns + interval_ns) // NS_PER_MS
                row[agg] = v
                out.append(row)
        h._send_json(200, {"success": True, "analytics": out})

    # -- consumption ---------------------------------------------------------

    def _consume_logs(self, h, method, repo, ls, params):
        """Kafka-like consumption, delegated to the shared consume
        implementation (services/consume parity; same opaque cursor)."""
        p = dict(params)
        p["db"] = repo
        p["measurement"] = ls
        h._handle_consume(p)

    def _consume_cursor_time(self, h, method, repo, ls, params):
        """Map a wall-clock time (ms) to a consume cursor."""
        if self._auth(h, params, "READ", repo) is None:
            return
        try:
            frm = int(params["from"])
        except (KeyError, ValueError):
            h._send_json(400, {"error": "from (ms) is required"})
            return
        h._send_json(200, {"cursor": f"{frm * NS_PER_MS}:0"})


def _fulltext_terms(node) -> list[str]:
    out: list[str] = []

    def walk(n):
        if isinstance(n, logparser.Term) and n.op == "match" and isinstance(
            n.value, str
        ):
            out.append(n.value)
        elif isinstance(n, (logparser.And, logparser.Or)):
            for c in n.children:
                walk(c)

    if node is not None:
        walk(node)
    return out
