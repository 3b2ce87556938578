"""Arrow Flight surface: columnar writes (DoPut) and query results
(DoGet) as Arrow record batches.

Reference: openGemini's arrow flight service (app/ts-server arrow flight
listener + coordinator RecordWriter path, services/arrowflight) — the
high-throughput columnar ingest alternative to line protocol. Here the
batch decodes straight into the structured write path (never through
line-protocol text), and DoGet streams a statement's result series as
one Arrow table.

DoPut descriptor (JSON): {"db": ..., "rp": ..., "measurement": ...,
"tag_columns": [...]} — remaining non-time columns are fields. A
column named "time" (int64, ns) is required.
DoGet ticket (JSON): {"db": ..., "q": "SELECT ..."}.

The port of ``opengemini_tpu/server/flight.py``, whole, with its imports
rewritten.
"""

from __future__ import annotations

import json

import numpy as np

from opengemini_tpu_torch.record import FieldType


def _require_flight():
    import pyarrow.flight as fl  # noqa: F401

    return fl


class FlightService:
    """pyarrow.flight server wrapper; start()/stop() like HttpService."""

    def __init__(self, engine, executor, host: str = "127.0.0.1",
                 port: int = 8087, users=None, auth_enabled: bool = False,
                 router=None):
        fl = _require_flight()
        self.engine = engine
        self.executor = executor
        self.users = users
        self.auth_enabled = auth_enabled
        self.router = router
        outer = self

        class _Server(fl.FlightServerBase):
            def __init__(self):
                super().__init__(f"grpc://{host}:{port}")

            def do_put(self, context, descriptor, reader, writer):
                meta = json.loads(descriptor.command or b"{}")
                user = outer._check_auth(meta)
                if user is not None and not user.can("WRITE", meta.get("db", "")):
                    raise fl.FlightUnauthorizedError("write not authorized")
                # write-path backpressure (resource governor): shed as
                # UNAVAILABLE — the flight analogue of HTTP 429 +
                # Retry-After (the window rides the message text)
                from opengemini_tpu_torch.utils.governor import GOVERNOR

                retry_after = GOVERNOR.write_backpressure()
                if retry_after is not None:
                    raise fl.FlightUnavailableError(
                        "write backpressure: memtable+WAL backlog over the "
                        f"high watermark; retry after {retry_after}s")
                table = reader.read_all()
                outer.write_table(
                    meta.get("db", ""), meta.get("rp"),
                    meta.get("measurement", ""),
                    list(meta.get("tag_columns", [])), table,
                )

            def do_get(self, context, ticket):
                req = json.loads(ticket.ticket or b"{}")
                user = outer._check_auth(req)
                from opengemini_tpu_torch.utils.governor import AdmissionRejected

                try:
                    table = outer.query_table(req.get("db", ""),
                                              req.get("q", ""), user=user)
                except AdmissionRejected as e:
                    # admission shed: UNAVAILABLE (flight analogue of the
                    # HTTP 503 + Retry-After)
                    raise fl.FlightUnavailableError(
                        f"{e}; retry after {e.retry_after_s}s") from None
                return fl.RecordBatchStream(table)

            def do_action(self, context, action):
                if action.type == "ping":
                    return iter([fl.Result(b"ok")])
                raise KeyError(f"unknown action {action.type!r}")

        self._server_cls = _Server
        self._server = None
        self._thread = None
        self.port = port

    def _check_auth(self, req: dict):
        """Credentials ride in the request JSON ({"u": ..., "p": ...}) —
        flight's gRPC handshake plumbing varies by pyarrow version, so the
        token travels in-band like the HTTP surface's u/p params. Returns
        the authenticated user (None when auth is off)."""
        if not self.auth_enabled:
            return None
        fl = _require_flight()
        from opengemini_tpu_torch.meta.users import AuthError

        try:
            return self.users.authenticate(req.get("u", ""), req.get("p", ""))
        except AuthError as e:
            raise fl.FlightUnauthenticatedError(str(e)) from None

    # -- conversion --------------------------------------------------------

    def write_table(self, db: str, rp, measurement: str,
                    tag_columns: list[str], table) -> int:
        if not db or not measurement:
            raise ValueError("db and measurement are required")
        import pyarrow as pa

        names = table.column_names
        if "time" not in names:
            raise ValueError("a 'time' column (int64 ns) is required")
        tcol = table.column("time")
        if tcol.null_count:
            # a null here would cast through NaN to -2^63 and be stored as
            # a "valid" garbage timestamp
            raise ValueError("'time' column must not contain nulls")
        if not pa.types.is_integer(tcol.type):
            raise ValueError("'time' column must be integer nanoseconds")
        times = np.asarray(tcol.to_numpy(zero_copy_only=False), dtype=np.int64)
        tag_cols = {
            n: table.column(n).to_pylist() for n in tag_columns if n in names
        }
        field_names = [n for n in names
                       if n != "time" and n not in tag_columns]
        field_data = []
        for n in field_names:
            col = table.column(n)
            t = col.type
            if pa.types.is_integer(t):
                ftype = FieldType.INT
            elif pa.types.is_floating(t):
                ftype = FieldType.FLOAT
            elif pa.types.is_boolean(t):
                ftype = FieldType.BOOL
            else:
                ftype = FieldType.STRING
            field_data.append((n, ftype, col.to_pylist()))
        points = []
        for i in range(len(table)):
            tags = tuple(sorted(
                (k, str(v[i])) for k, v in tag_cols.items()
                if v[i] is not None
            ))
            fields = {}
            for n, ftype, vals in field_data:
                v = vals[i]
                if v is None:
                    continue
                if ftype == FieldType.STRING:
                    v = str(v)
                fields[n] = (ftype, v)
            if fields:
                points.append((measurement, tags, int(times[i]), fields))
        if not points:
            return 0
        if self.router is not None:
            return self.router.routed_write(db, rp, points)
        return self.engine.write_rows(db, points, rp=rp)

    def query_table(self, db: str, q: str, user=None):
        import pyarrow as pa

        # read_only like HTTP GET: the result-streaming endpoint must not
        # execute mutating statements
        res = self.executor.execute(q, db=db, user=user,
                                    read_only=True)["results"][0]
        if "error" in res:
            fl = _require_flight()
            raise fl.FlightServerError(res["error"])
        series = res.get("series", [])
        if not series:
            return pa.table({})
        # one table over the UNION of all series' columns (multi-source
        # selects differ per series) plus tag columns; a tag key that is
        # also a result column keeps the column value
        tag_keys = sorted({k for s in series for k in (s.get("tags") or {})})
        all_cols: list[str] = []
        for s in series:
            for c in s["columns"]:
                if c not in all_cols:
                    all_cols.append(c)
        out_cols = all_cols + [k for k in tag_keys if k not in all_cols]
        data: dict[str, list] = {c: [] for c in out_cols}
        for s in series:
            tags = s.get("tags") or {}
            cols = s["columns"]
            for row in s["values"]:
                rowmap = dict(zip(cols, row))
                for c in out_cols:
                    if c in rowmap:
                        data[c].append(rowmap[c])
                    else:
                        data[c].append(tags.get(c))
        return pa.table(data)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        import threading

        self._server = self._server_cls()
        self.port = self._server.port  # real bound port (supports port=0)
        self._thread = threading.Thread(
            target=self._server.serve, daemon=True, name="flight"
        )
        self._thread.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
