"""ts-monitor: the EXTERNAL monitoring agent.

Reference: app/ts-monitor/collector/{collect,node_monitor,query,report}.go
— a separate process that watches server nodes from the OUTSIDE (an
in-process stats pusher cannot observe a wedged server) and reports what
it sees as regular time-series into a monitor database.

Per tick, for each target node:
  - /ping latency + up/down (a hung or dead process reports up=0)
  - /debug/vars counters (every stats module), flattened to fields
  - host-level process stats of the TARGET's pid when given a pidfile
    (rss/cpu from /proc — the reference's node_monitor role)
and writes `ogmonitor_up` + `ogmonitor_stats` line protocol to the
report server, creating the monitor database once on startup.

Run: ``python -m opengemini_tpu_torch.tools.monitor_agent \
    -targets 127.0.0.1:8086,10.0.0.2:8086 -report 127.0.0.1:8086 \
    -db monitor -interval 10``

The port of ``opengemini_tpu/tools/monitor_agent.py``, whole, with its
imports rewritten.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request


def _get_json(url: str, timeout: float) -> dict | None:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read())
    except (OSError, ValueError):
        return None


def _escape_tag(v: str) -> str:
    return v.replace("\\", "\\\\").replace(",", "\\,").replace(" ", "\\ ") \
        .replace("=", "\\=")


_escape_field_key = _escape_tag  # same rules (stats counter names can
# carry spaces/colons, e.g. per-stage trace counters)


def probe_target(target: str, timeout: float = 5.0) -> dict:
    """One observation of one node: up/ping + flattened stats counters."""
    t0 = time.perf_counter()
    up = False
    try:
        with urllib.request.urlopen(f"http://{target}/ping",
                                    timeout=timeout) as r:
            up = r.status in (200, 204)
    except OSError:
        pass
    ping_ms = (time.perf_counter() - t0) * 1e3
    out = {"up": up, "ping_ms": round(ping_ms, 3), "stats": {}}
    if not up:
        return out
    vars_doc = _get_json(f"http://{target}/debug/vars", timeout)
    if isinstance(vars_doc, dict):
        for module, counters in vars_doc.items():
            if not isinstance(counters, dict):
                continue
            for name, val in counters.items():
                if isinstance(val, bool) or not isinstance(val, (int, float)):
                    continue
                out["stats"][f"{module}_{name}"] = val
    return out


def proc_stats(pidfile: str) -> dict:
    """rss/threads of the watched process from /proc (node_monitor role).
    Empty when the pidfile or process is gone — which is itself signal."""
    try:
        with open(pidfile, encoding="utf-8") as f:
            pid = int(f.read().strip())
        with open(f"/proc/{pid}/status", encoding="utf-8") as f:
            fields = dict(
                line.split(":", 1) for line in f if ":" in line)
        return {
            "rss_kb": int(fields["VmRSS"].strip().split()[0]),
            "threads": int(fields["Threads"].strip()),
        }
    except (OSError, KeyError, ValueError):
        return {}


def collect_once(targets: list[str], pidfiles: dict[str, str] | None = None,
                 now_ns: int | None = None, timeout: float = 5.0) -> str:
    """One collection round -> line protocol for the monitor database."""
    now_ns = now_ns if now_ns is not None else time.time_ns()
    lines: list[str] = []
    for target in targets:
        tag = _escape_tag(target)
        obs = probe_target(target, timeout)
        lines.append(
            f"ogmonitor_up,target={tag} up={int(obs['up'])}i,"
            f"ping_ms={obs['ping_ms']} {now_ns}")
        if obs["stats"]:
            fields = ",".join(
                f"{_escape_field_key(k)}={v}"
                + ("i" if isinstance(v, int) else "")
                for k, v in sorted(obs["stats"].items()))
            lines.append(f"ogmonitor_stats,target={tag} {fields} {now_ns}")
        pf = (pidfiles or {}).get(target)
        if pf:
            ps = proc_stats(pf)
            if ps:
                lines.append(
                    f"ogmonitor_proc,target={tag} "
                    f"rss_kb={ps['rss_kb']}i,threads={ps['threads']}i "
                    f"{now_ns}")
    return "\n".join(lines)


def report(report_addr: str, db: str, lines: str, timeout: float = 10.0) -> bool:
    if not lines:
        return True
    req = urllib.request.Request(
        f"http://{report_addr}/write?db={urllib.parse.quote(db, safe='')}",
        data=lines.encode(), method="POST")
    try:
        urllib.request.urlopen(req, timeout=timeout).read()
        return True
    except OSError:
        return False


def ensure_db(report_addr: str, db: str, timeout: float = 10.0) -> None:
    req = urllib.request.Request(
        f"http://{report_addr}/query?q=" + urllib.parse.quote(
            f'CREATE DATABASE "{db}"'),
        data=b"", method="POST")
    try:
        urllib.request.urlopen(req, timeout=timeout).read()
    except OSError:
        pass  # retried implicitly: writes 404 until the db exists


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ts-monitor", description="external node monitoring agent")
    ap.add_argument("-targets", required=True,
                    help="comma-separated host:port list to watch")
    ap.add_argument("-report", required=True,
                    help="host:port that receives the monitor series")
    ap.add_argument("-db", default="monitor")
    ap.add_argument("-interval", type=float, default=10.0)
    ap.add_argument("-pidfiles", default="",
                    help="comma-separated target=pidfile pairs")
    ap.add_argument("-once", action="store_true",
                    help="collect and report one round, then exit")
    args = ap.parse_args(argv)
    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    pidfiles = {}
    for pair in args.pidfiles.split(","):
        if "=" in pair:
            t, p = pair.split("=", 1)
            pidfiles[t.strip()] = p.strip()
    ensure_db(args.report, args.db)
    while True:
        lines = collect_once(targets, pidfiles)
        ok = report(args.report, args.db, lines)
        if not ok:
            print(f"ts-monitor: report to {args.report} failed", flush=True)
        if args.once:
            return 0 if ok else 1
        time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
