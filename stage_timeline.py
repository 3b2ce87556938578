"""Where a short query's request wall goes outside the query stages.

Loads chip_smoke.py's phase 3 data (TSBS cpu-only, random walks from a
seed) into the port's memtable, serves it with the port's HttpService
and sends Q3 (five maxima of one host, GROUP BY time(1m)) over one
kept-alive connection, as phase 3 does. For each request it records
when the client sent it, when the server began to parse it, each
query stage's end (utils/tracing.record_stage) and length, the
executor's entry and exit, the handler's end, the client's header parse
and the answer's last byte. It prints, per pass:

- phase 3's stage split of the pass (chip_smoke.stage_split, the
  check that holds each query's stages to 90% of its request walls);
- each request's stage sum over its wall;
- the gaps that no stage covers, named by the events around them and
  summed over the pass;
- the GC pauses inside and outside the stages; with --sample, the
  server thread's stacks sampled every 0.5 ms outside the stages.

  python3 stage_timeline.py                    # the card, 4000 hosts, 4 h
  python3 stage_timeline.py --device cpu --hosts 300 --hours 3
  python3 stage_timeline.py --one-write        # alternate the two ways
                                               # a response is written
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import shutil
import statistics
import sys
import threading
import time
import traceback
import urllib.parse

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hosts", type=int, default=4000)
    ap.add_argument("--hours", type=int, default=4)
    ap.add_argument("--runs", type=int, default=30,
                    help="requests a pass")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--sample", action="store_true",
                    help="sample the server thread's stack (it slows "
                         "every request)")
    ap.add_argument("--one-write", action="store_true",
                    help="odd passes write a response's headers and "
                         "body in one write, even passes as the server "
                         "does")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    os.environ["OGT_RESULT_CACHE"] = "0"
    import numpy as np
    import torch

    if args.device == "cpu":
        torch.cuda.synchronize = lambda *a, **k: None
    elif not torch.cuda.is_available():
        print("stage_timeline: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from opengemini_tpu_torch import convert
    from opengemini_tpu_torch.ingest.line_protocol import series_key
    from opengemini_tpu_torch.query import executor as executor_mod
    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.storage.engine import Engine
    from opengemini_tpu_torch.utils import tracing

    if args.device == "cuda":
        C.build_all()
    n_t = args.hours * 360
    rng = np.random.default_rng(args.seed)
    tags = C.host_tags(args.hosts, rng)
    vals = C.make_values(args.hosts, n_t, rng)
    root = os.path.join(ROOT, "build", "stage_timeline")
    shutil.rmtree(root, ignore_errors=True)
    engine = Engine(root, flush_threshold_bytes=1 << 40, device=args.device)
    svc = HttpService(engine, port=0)
    svc.start()
    try:
        C.disarm_planner(svc.port)
        C.http(svc.port, "POST", "/query", {"q": "CREATE DATABASE benchmark"})
        times = C.T0_NS + np.arange(n_t, dtype=np.int64) * C.STEP_NS
        n = args.hosts * n_t
        table = {
            "series_keys": [series_key("cpu", t) for t in tags],
            "series": np.repeat(np.arange(args.hosts, dtype=np.int64), n_t),
            "times": np.tile(times, args.hosts),
            "fields": {f: (np.ascontiguousarray(vals[f]).reshape(-1),
                           np.ones(n, dtype=np.bool_)) for f in C.FIELDS}}
        t = time.perf_counter()
        convert.load_columnar(engine, "benchmark", {"cpu": table})
        del table
        print(f"loaded {n} rows in {time.perf_counter() - t:.1f} s",
              flush=True)
        where = (f"time >= '2016-01-01T00:00:00Z' AND "
                 f"time < '2016-01-01T{args.hours:02d}:00:00Z'")
        f5 = C.FIELDS[:5]
        q1 = ("SELECT mean(usage_user), max(usage_user), count(usage_user) "
              f"FROM cpu WHERE {where} GROUP BY time(1m)")
        q2 = ("SELECT " + ", ".join(f"mean({f})" for f in f5)
              + f" FROM cpu WHERE {where} GROUP BY time(1h), hostname")
        q3 = ("SELECT " + ", ".join(f"max({f})" for f in f5)
              + f" FROM cpu WHERE hostname='host_7' AND {where} "
              "GROUP BY time(1m)")
        # phase 3 runs Q1 and Q2 before Q3
        for q in (q1, q1, q2, q2):
            C.query_timed(svc.port, q)
        Timeline(C, svc, tracing, executor_mod, q3, args).run()
    finally:
        C.stop_server(svc, engine)
        shutil.rmtree(root, ignore_errors=True)
    return 0


class Timeline:
    """Event recorder around one server: (time s, thread, kind, name,
    length s) events while `on`."""

    def __init__(self, C, svc, tracing, executor_mod, q, args):
        self.C, self.svc, self.q, self.args = C, svc, q, args
        self.events: list = []
        self.gcs: list = []
        self.samples: list = []
        self.on = False
        self.server_tid = None
        self._gc_t0 = None
        self._patch(tracing, executor_mod)

    def _ev(self, kind: str, name: str, length: float = 0.0) -> None:
        if self.on:
            self.events.append((time.perf_counter(), threading.get_ident(),
                                kind, name, length))

    def _patch(self, tracing, executor_mod) -> None:
        tl = self
        record_stage = tracing.record_stage

        def recorded(name, ns):
            tl._ev("stage", name, ns / 1e9)
            return record_stage(name, ns)

        tracing.record_stage = recorded
        handler = self.svc.httpd.RequestHandlerClass
        self.handler = handler
        parse_request = handler.parse_request
        handle_one = handler.handle_one_request

        def parse(h):
            tl._ev("mark", "parse_request")
            return parse_request(h)

        def handle(h):
            handle_one(h)
            tl._ev("mark", "handler_end")

        handler.parse_request = parse
        handler.handle_one_request = handle
        execute = executor_mod.Executor.execute

        def timed_execute(ex, *a, **kw):
            tl._ev("mark", "execute0")
            try:
                return execute(ex, *a, **kw)
            finally:
                tl._ev("mark", "execute1")

        executor_mod.Executor.execute = timed_execute

        def on_gc(phase, info):
            if not tl.on:
                return
            if phase == "start":
                tl._gc_t0 = time.perf_counter()
            elif tl._gc_t0 is not None:
                tl.gcs.append((tl._gc_t0, time.perf_counter()))
                tl._gc_t0 = None

        gc.callbacks.append(on_gc)
        self.send = handler._send

    def _one_write_send(self, h, code, payload=b"",
                        ctype="application/json", headers=None):
        """server/http.py's _send with the headers and the body in one
        write."""
        h.send_response(code)
        if payload:
            h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(payload)))
        h.send_header("X-Influxdb-Version", "1.8.0-" + h.server_version.split("/")[-1])
        for k, v in (headers or {}).items():
            h.send_header(k, v)
        h._headers_buffer.append(b"\r\n")
        data = b"".join(h._headers_buffer) + payload
        h._headers_buffer = []
        h.wfile.write(data)

    def _sampler(self, stop: threading.Event) -> None:
        while not stop.is_set():
            time.sleep(0.0005)
            frame = sys._current_frames().get(self.server_tid)
            if not self.on or frame is None:
                continue
            stack = [(os.path.relpath(f.filename, ROOT)
                      if f.filename.startswith(ROOT)
                      else os.path.basename(f.filename), f.name, f.lineno)
                     for f in traceback.extract_stack(frame)[-14:]]
            self.samples.append((time.perf_counter(), stack))

    def run(self) -> None:
        C = self.C
        # the connection's handler thread: the one that parses requests
        C.query_timed(self.svc.port, self.q)
        self.on = True
        C.query_timed(self.svc.port, self.q)
        self.on = False
        self.server_tid = next(e[1] for e in self.events
                               if e[3] == "parse_request")
        for k in range(self.args.passes):
            one = self.args.one_write and k % 2 == 1
            tl = self

            def send(h, *a, **kw):
                return tl._one_write_send(h, *a, **kw)

            self.handler._send = send if one else self.send
            print(f"=== pass {k + 1}: "
                  f"{'one write' if one else 'as the server writes'}"
                  f"{', stacks sampled' if self.args.sample else ''}",
                  flush=True)
            self.measure()
        self.handler._send = self.send
        conn = C._CONNS[self.svc.port]
        ping = []
        for _ in range(30):
            t0 = time.perf_counter()
            conn.request("GET", "/ping")
            conn.getresponse().read()
            ping.append(time.perf_counter() - t0)
        print(f"/ping round trip: median {statistics.median(ping) * 1e3:.3f}"
              f" ms, max {max(ping) * 1e3:.3f} ms")

    def measure(self) -> None:
        import torch

        C, port = self.C, self.svc.port
        self.events.clear()
        self.gcs.clear()
        self.samples.clear()
        stop = threading.Event()
        sampler = None
        if self.args.sample:
            sampler = threading.Thread(target=self._sampler, args=(stop,),
                                       daemon=True)
            sampler.start()
        conn = C._CONNS[port]
        path = "/query?" + urllib.parse.urlencode(
            {"db": "benchmark", "q": self.q, "epoch": "ns"})
        requests = []
        st0 = C.stage_ns(port)
        self.on = True
        for _ in range(self.args.runs):
            t0 = time.perf_counter()
            conn.request("GET", path)
            t_sent = time.perf_counter()
            r = conn.getresponse()
            t_headers = time.perf_counter()
            data = r.read()
            t1 = time.perf_counter()
            json.loads(data)
            torch.cuda.synchronize()
            requests.append((t0, t1))
            self.events.append((t_sent, self.server_tid, "mark",
                                "client_sent", 0.0))
            self.events.append((t_headers, self.server_tid, "mark",
                                "client_headers", 0.0))
        self.on = False
        stop.set()
        if sampler is not None:
            sampler.join()
        C.stage_split(port, st0, [(b - a) * 1e3 for a, b in requests],
                      "Q3 (phase 3's split)")
        self.report(requests)

    def report(self, requests: list) -> None:
        C = self.C
        evs_all = [e for e in self.events if e[1] == self.server_tid]
        gaps = collections.Counter()
        leaves = collections.Counter()
        shares, gc_in, gc_out = [], 0.0, 0.0
        for k, (c0, c1) in enumerate(requests):
            nxt = requests[k + 1][0] if k + 1 < len(requests) else 1e300
            evs = [e for e in evs_all if c0 <= e[0] < nxt]
            spans = sorted((e[0] - e[4], e[0], e[3]) for e in evs
                           if e[2] == "stage" and e[3] in C.STAGES)
            merged: list = []
            for a, b, _n in spans:
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            shares.append(sum(e[4] for e in evs if e[2] == "stage"
                              and e[3] in C.STAGES) / (c1 - c0))

            def covered(t, merged=merged):
                return any(a <= t <= b for a, b in merged)

            points = sorted(
                [(a, "start:" + n) for a, _b, n in spans]
                + [(b, "end:" + n) for _a, b, n in spans]
                + [(e[0], "mark:" + e[3]) for e in evs if e[2] == "mark"]
                + [(c0, "mark:client_send"), (c1, "mark:client_recv")])
            for (t1, n1), (t2, n2) in zip(points, points[1:]):
                if t2 > t1 and not covered((t1 + t2) / 2):
                    gaps[f"{n1} -> {n2}"] += t2 - t1
            for ts, stack in self.samples:
                if c0 <= ts <= c1 and not covered(ts):
                    ours = [x for x in stack
                            if x[0].startswith(("opengemini", "chip_smoke"))]
                    leaf = ours[-1] if ours else stack[-1]
                    leaves[f"{leaf[0]}:{leaf[1]}:{leaf[2]}"] += 1
            for g0, g1 in self.gcs:
                if c0 <= g0 <= c1:
                    if covered((g0 + g1) / 2):
                        gc_in += g1 - g0
                    else:
                        gc_out += g1 - g0
        walls = [b - a for a, b in requests]
        print(f"{len(walls)} requests: wall {sum(walls) * 1e3:.1f} ms, "
              f"median {statistics.median(walls) * 1e3:.2f} ms; stages over "
              f"the wall per request: min {min(shares):.3f}, median "
              f"{statistics.median(shares):.3f}")
        print("per request: " + " ".join(f"{x:.3f}" for x in shares))
        print(f"GC pauses: {len(self.gcs)}, {gc_in * 1e3:.2f} ms inside the "
              f"stages, {gc_out * 1e3:.2f} ms outside")
        print("outside every stage (ms summed over the requests):")
        for name, s in gaps.most_common(20):
            print(f"  {s * 1e3:8.2f}  {name}")
        if self.samples:
            print("stack samples outside every stage, by innermost frame "
                  "of the repo:")
            for name, cnt in leaves.most_common(20):
                print(f"  {cnt:5d}  {name}")


if __name__ == "__main__":
    sys.exit(main())
