"""MCP (Model Context Protocol) server: exposes the database to AI
agents as tools over stdio JSON-RPC.

Reference: the openGemini MCP server (opengemini-mcp) — a thin bridge
that connects to a running server and offers query/write/schema tools.
Run: `python -m opengemini_tpu_torch.tools.mcp_server --url http://host:8086
[--db mydb] [--user u --password p]`.

Transport: newline-delimited JSON-RPC 2.0 on stdin/stdout (the MCP stdio
transport). Tools:
  query             InfluxQL SELECT/SHOW (read-only)
  write             line-protocol write
  list_databases    SHOW DATABASES
  list_measurements SHOW MEASUREMENTS on a database

The port of ``opengemini_tpu/tools/mcp_server.py``, whole, with its
imports rewritten.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.parse
import urllib.request

PROTOCOL_VERSION = "2024-11-05"

TOOLS = [
    {
        "name": "query",
        "description": "Run a read-only InfluxQL query (SELECT/SHOW) and "
                       "return the JSON result.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "q": {"type": "string", "description": "InfluxQL text"},
                "db": {"type": "string", "description": "target database"},
            },
            "required": ["q"],
        },
    },
    {
        "name": "write",
        "description": "Write line-protocol points.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "lines": {"type": "string"},
                "db": {"type": "string"},
            },
            "required": ["lines", "db"],
        },
    },
    {
        "name": "list_databases",
        "description": "List databases.",
        "inputSchema": {"type": "object", "properties": {}},
    },
    {
        "name": "list_measurements",
        "description": "List measurements in a database.",
        "inputSchema": {
            "type": "object",
            "properties": {"db": {"type": "string"}},
            "required": ["db"],
        },
    },
]


class Backend:
    """HTTP client to a running ts-server."""

    def __init__(self, url: str, db: str = "", user: str = "",
                 password: str = "", timeout_s: float = 30.0):
        self.url = url.rstrip("/")
        self.db = db
        self.user = user
        self.password = password
        self.timeout_s = timeout_s

    def _creds(self) -> dict:
        return {"u": self.user, "p": self.password} if self.user else {}

    def query(self, q: str, db: str = "") -> dict:
        # GET: the server enforces read-only on GET /query, which backs
        # the tool's "read-only" promise (agents cannot DROP through it)
        params = {"q": q, "db": db or self.db, **self._creds()}
        url = f"{self.url}/query?{urllib.parse.urlencode(params)}"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return json.loads(r.read())

    def write(self, lines: str, db: str) -> None:
        params = {"db": db, **self._creds()}
        req = urllib.request.Request(
            f"{self.url}/write?{urllib.parse.urlencode(params)}",
            data=lines.encode(), method="POST",
        )
        urllib.request.urlopen(req, timeout=self.timeout_s).read()


def _tool_result(payload) -> dict:
    return {"content": [{"type": "text",
                         "text": json.dumps(payload, default=str)}]}


def call_tool(backend: Backend, name: str, args: dict) -> dict:
    if name == "query":
        res = backend.query(args["q"], args.get("db", ""))
        return _tool_result(res)
    if name == "write":
        backend.write(args["lines"], args["db"])
        return _tool_result({"ok": True})
    if name == "list_databases":
        res = backend.query("SHOW DATABASES")
        series = res["results"][0].get("series", [])
        names = [v[0] for s in series for v in s.get("values", [])]
        return _tool_result({"databases": names})
    if name == "list_measurements":
        res = backend.query("SHOW MEASUREMENTS", db=args["db"])
        series = res["results"][0].get("series", [])
        names = [v[0] for s in series for v in s.get("values", [])]
        return _tool_result({"measurements": names})
    raise KeyError(f"unknown tool {name!r}")


def handle(backend: Backend, msg: dict) -> dict | None:
    """One JSON-RPC request -> response (None for notifications)."""
    method = msg.get("method", "")
    mid = msg.get("id")
    if method.startswith("notifications/"):
        return None

    def ok(result):
        return {"jsonrpc": "2.0", "id": mid, "result": result}

    def err(code, text):
        return {"jsonrpc": "2.0", "id": mid,
                "error": {"code": code, "message": text}}

    try:
        if method == "initialize":
            return ok({
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": {"tools": {}},
                "serverInfo": {"name": "opengemini-tpu",
                               "version": "0.1"},
            })
        if method == "ping":
            return ok({})
        if method == "tools/list":
            return ok({"tools": TOOLS})
        if method == "tools/call":
            params = msg.get("params", {})
            try:
                return ok(call_tool(backend, params.get("name", ""),
                                    params.get("arguments", {}) or {}))
            except KeyError as e:
                return err(-32602, str(e))
            except Exception as e:  # noqa: BLE001 — tool errors are results
                return ok({"content": [{"type": "text", "text": str(e)}],
                           "isError": True})
        return err(-32601, f"method not found: {method}")
    except Exception as e:  # noqa: BLE001
        return err(-32603, str(e))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="opengemini-tpu-mcp")
    ap.add_argument("--url", default="http://127.0.0.1:8086")
    ap.add_argument("--db", default="")
    ap.add_argument("--user", default="")
    ap.add_argument("--password", default="")
    args = ap.parse_args(argv)
    backend = Backend(args.url, args.db, args.user, args.password)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except ValueError:
            continue
        if not isinstance(msg, dict):
            continue  # valid JSON, not a request object
        resp = handle(backend, msg)
        if resp is not None:
            sys.stdout.write(json.dumps(resp) + "\n")
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
