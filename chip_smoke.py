#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opengemini_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--hours H] [--seed S]

Phases, in order; any failure ends the run with a nonzero exit:

1. Device and build: requires CUDA, prints the card's name and power
   limit (nvidia-smi), builds the three CUDA kernels from csrc/ (nvcc,
   sm_90a, one process per source, in parallel).
2. Kernels against their plain PyTorch versions on the card, on seeded
   data (70% mask density, fully empty rows, value and time ties):
   count/min/max/first/last/sel_* must match exactly, sum/mean/ssd within
   rtol 1e-10 (summation order).
3. End to end on a TSBS devops cpu-only deployment (4000 hosts, the 10
   cpu tags, the 10 usage_* fields, one sample every 10 s for 12 h from
   2016-01-01T00:00:00Z): the port's HTTP server on localhost takes
   CREATE DATABASE, the first minute of every host as line protocol on
   /write and the rest through convert.load_columnar; four queries run
   5 times each through /query and every answer is checked against a
   numpy oracle (counts, min, max, first, last exact; mean, stddev rtol
   1e-9). The launch counters are read around each query's five runs:
   Q1-Q3 must launch the grid kernel (and raise the grid-batch counter),
   Q4 both bucket kernels. Then a sixth run of each query, all four in
   one torch.profiler session, each in an annotation: per query the
   device's busy time (the union of its kernel, copy and memset spans),
   its kernels' time, its copies each way, over the run's wall, and how
   many of the run's device calls the trace holds no record of.
4. The kernels again, at the shapes the end-to-end phase gave them:
   checked and timed (CUDA events, median of 20 launches).

Output: progress lines, then a {"kernels": [...]} line, the nvidia-smi
line, and last {"ok": true, "device": {...}}. Without CUDA (or without
the opengemini_tpu_torch package beside this file) it exits nonzero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.parse
import urllib.request

T0_NS = 1451606400 * 10**9  # 2016-01-01T00:00:00Z
STEP_NS = 10 * 10**9
FIELDS = ("usage_user", "usage_system", "usage_idle", "usage_nice",
          "usage_iowait", "usage_irq", "usage_softirq", "usage_steal",
          "usage_guest", "usage_guest_nice")
REGIONS = ("us-east-1", "us-west-1", "us-west-2", "eu-west-1",
           "eu-central-1", "ap-southeast-1", "ap-southeast-2",
           "ap-northeast-1", "sa-east-1")
MEAN_RTOL = 1e-9
KERNEL_RTOL = 1e-10
N_HOSTS = 4000
# H100 SXM peaks (NVIDIA data sheet): device memory bytes/s and fp64
# (non-tensor) flop/s
H100_PEAKS = (3.35e12, 34e12)
# the kernels' __global__ names in csrc/, as a profiler trace shows them
PORT_KERNELS = ("bucket_basic_kernel", "bucket_selectors_kernel",
                "grid_window_kernel")
REPLACES = {
    "bucket_stats_basic": "opengemini_tpu/ops/pallas_segment.py:143",
    "bucket_stats_selectors": "opengemini_tpu/ops/pallas_segment.py:274",
    "grid_window_agg": "opengemini_tpu/ops/pallas_segment.py:328",
}


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing and bounds --------------------------------------------------------


def time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` single launches, each between two CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def peaks(name: str):
    if "H100" not in name:
        raise CheckFailed(f"no peak rates for {name!r}: the bounds are "
                          "for an H100")
    return H100_PEAKS


def bound(name: str, shape, n_valid: int, dev_name: str):
    """(bound_ms, bound_by): the larger of the least bytes the function
    must move (mask bytes, the masked-in values and times, the outputs)
    over the memory rate and its fp64 operations over the fp64 rate."""
    bw, flops = peaks(dev_name)
    if name == "grid_window_agg":
        s, k, w = shape
        cells, rows = s * k * w, s * w
        nbytes = cells + n_valid * 8 + rows * (4 + 4 * 8)
        ops = 5 * n_valid
    elif name == "bucket_stats_basic":
        g, w = shape
        cells, rows = g * w, g
        nbytes = cells + n_valid * 8 + rows * (4 + 5 * 8)
        ops = 8 * n_valid
    else:
        g, w = shape
        cells, rows = g * w, g
        nbytes = cells + n_valid * (8 + 4 + 4) + rows * (2 * 8 + 4 * 4) \
            + 6 * rows * 4
        ops = 8 * n_valid
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2/4: kernels against their plain versions -----------------------------


def make_inputs(kind: str, shape, seed: int):
    """Seeded inputs on the card: 70% mask density, every 97th row fully
    empty, integer-valued values (ties) on even rows, few distinct times
    (time ties) on every third row."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    if kind == "grid":
        s, k, w = shape
        v = torch.rand(shape, generator=g, device=dev, dtype=torch.float64) * 100
        v[::2] = torch.floor(v[::2] / 10)
        m = torch.rand(shape, generator=g, device=dev) < 0.7
        m[::97] = False
        return {"v": v, "m": m}
    rows, w = shape
    v = torch.rand(shape, generator=g, device=dev, dtype=torch.float64) * 100
    v[::2] = torch.floor(v[::2] / 10)
    m = torch.rand(shape, generator=g, device=dev) < 0.7
    m[::97] = False
    hi = torch.randint(0, 1 << 20, shape, generator=g, device=dev,
                       dtype=torch.int32)
    lo = torch.randint(0, 1 << 30, shape, generator=g, device=dev,
                       dtype=torch.int32)
    hi[::3] = torch.randint(0, 2, (hi[::3].shape[0], w), generator=g,
                            device=dev, dtype=torch.int32)
    lo[::3] = torch.randint(0, 3, (lo[::3].shape[0], w), generator=g,
                            device=dev, dtype=torch.int32)
    idx = torch.randint(0, 1 << 30, shape, generator=g, device=dev,
                        dtype=torch.int32)
    return {"v": v, "hi": hi, "lo": lo, "idx": idx, "m": m}


EXACT = {"count", "min", "max", "first", "last", "sel_first", "sel_last",
         "sel_min", "sel_max"}


def compare(name: str, got: dict, want: dict) -> float:
    """Exact keys equal, float sums within KERNEL_RTOL; returns the max
    absolute error over all outputs."""
    import torch

    err = 0.0
    check(set(got) == set(want), f"{name}: outputs {sorted(got)} != {sorted(want)}")
    for key in want:
        a, b = got[key], want[key]
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}.{key}: {a.shape}/{a.dtype} != {b.shape}/{b.dtype}")
        if key in EXACT:
            same = torch.equal(a, b) if not a.is_floating_point() else bool(
                ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
            check(same, f"{name}.{key} differs from the plain version")
        else:
            tol = KERNEL_RTOL * torch.maximum(a.abs(), b.abs()) + 1e-300
            check(bool(((a - b).abs() <= tol).all()),
                  f"{name}.{key} beyond rtol {KERNEL_RTOL}")
        if a.numel():
            d = (a.double() - b.double()).abs()
            d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
            err = max(err, float(d.max()))
    return err


def kernel_case(name: str, shape, seed: int, dev_name: str, timed: bool):
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs

    if name == "grid_window_agg":
        x = make_inputs("grid", shape, seed)
        run = lambda: cs.grid_window_agg(x["v"], x["m"])  # noqa: E731
        plain = lambda: cs.grid_window_agg_plain(x["v"], x["m"])  # noqa: E731
    elif name == "bucket_stats_basic":
        x = make_inputs("bucket", shape, seed)
        run = lambda: cs.bucket_stats_basic(x["v"], x["m"])  # noqa: E731
        plain = lambda: cs.bucket_stats_basic_plain(x["v"], x["m"])  # noqa: E731
    else:
        x = make_inputs("bucket", shape, seed)
        args = (x["v"], x["hi"], x["lo"], x["idx"], x["m"])
        run = lambda: cs.bucket_stats_selectors(*args)  # noqa: E731
        plain = lambda: cs.bucket_stats_selectors_plain(*args)  # noqa: E731
    got = run()
    want = plain()
    torch.cuda.synchronize()
    err = compare(f"{name}{tuple(shape)}", got, want)
    n_valid = int(x["m"].sum())
    b_ms, b_by = bound(name, shape, n_valid, dev_name)
    rec = {"shape": list(shape), "max_abs_err": err, "bound_ms": b_ms,
           "bound_by": b_by}
    if timed:
        rec["ms"] = time_ms(run)
        rec["plain_ms"] = time_ms(plain, reps=5)
    del x, got, want
    torch.cuda.empty_cache()
    return rec


# phase 2: every bucket width of the ladder (models/ragged.py WIDTHS) at
# a large row count, the 4000-host Q4 shape, and the unpadded Q1/Q2 grids
CHECK_SHAPES = {
    "bucket_stats_basic": [(131072, 16), (131072, 64), (131072, 256),
                           (32768, 1024)],
    "bucket_stats_selectors": [(131072, 16), (131072, 64), (131072, 256),
                               (32768, 1024)],
    "grid_window_agg": [(4000, 6, 720), (4000, 360, 12)],
}


def phase_kernels(dev_name: str, seed: int) -> dict:
    results = {}
    for i, (name, shapes) in enumerate(CHECK_SHAPES.items()):
        results[name] = []
        for j, shape in enumerate(shapes):
            rec = kernel_case(name, shape, seed + 100 * i + j, dev_name,
                              timed=True)
            results[name].append(rec)
            log(f"[kernel] {name}{tuple(shape)} ok max_abs_err="
                f"{rec['max_abs_err']:.3e} ms={rec['ms']:.4f} "
                f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f}")
    return results


# -- phase 3: end to end ---------------------------------------------------


def host_tags(n_hosts: int, rng):
    """The 10 TSBS cpu tags per host, as sorted (key, value) tuples."""
    out = []
    for h in range(n_hosts):
        region = REGIONS[int(rng.integers(len(REGIONS)))]
        tags = {
            "hostname": f"host_{h}",
            "region": region,
            "datacenter": f"{region}{'abc'[int(rng.integers(3))]}",
            "rack": str(int(rng.integers(100))),
            "os": ("Ubuntu16.10", "Ubuntu16.04LTS", "Ubuntu15.10")[
                int(rng.integers(3))],
            "arch": ("x64", "x86")[int(rng.integers(2))],
            "team": ("SF", "NYC", "LON", "CHI")[int(rng.integers(4))],
            "service": str(int(rng.integers(20))),
            "service_version": str(int(rng.integers(2))),
            "service_environment": ("production", "staging", "test")[
                int(rng.integers(3))],
        }
        out.append(tuple(sorted(tags.items())))
    return out


def make_values(n_hosts: int, n_t: int, rng):
    """Per field a (hosts, samples) float64 random walk held in [0, 100]
    (the TSBS cpu field model)."""
    import numpy as np

    vals = {}
    for f in FIELDS:
        start = rng.random((n_hosts, 1)) * 100.0
        steps = rng.normal(0.0, 1.0, (n_hosts, n_t))
        steps[:, 0] = 0.0
        vals[f] = np.clip(start + np.cumsum(steps, axis=1), 0.0, 100.0)
    return vals


def http(port: int, method: str, path: str, params: dict, body: bytes = b""):
    url = f"http://127.0.0.1:{port}{path}?{urllib.parse.urlencode(params)}"
    req = urllib.request.Request(url, data=body if method == "POST" else None,
                                 method=method)
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
        return r.status, (json.loads(data) if data else None)


def query(port: int, q: str) -> dict:
    status, doc = http(port, "GET", "/query",
                       {"db": "benchmark", "q": q, "epoch": "ns"})
    check(status == 200, f"/query status {status}")
    res = doc["results"][0]
    check("error" not in res, f"query error: {res.get('error')}")
    return res


def close(a, b, rtol=MEAN_RTOL) -> bool:
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return bool(np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(a),
                                                          np.abs(b))))


def merged_ms(spans) -> float:
    """Length of the union of (start, end) microsecond spans, in ms."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


# runtime calls that put one activity (kernel, copy, memset) on the device
DEVICE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
                "cudaMemcpy", "cudaMemsetAsync", "cudaMemset")


def device_time(events, start: float, end: float) -> dict:
    """Device activity that a run between host times start and end (us,
    the trace's clock) put on the card, from torch.profiler's chrome
    trace events. `missing` counts the run's runtime calls whose device
    activity the trace lacks (0 when the trace is complete)."""
    busy, kernels, copies = [], [], {"HtoD": [], "DtoH": []}
    nbytes = {"HtoD": 0, "DtoH": 0}
    port_ms = other_ms = 0.0
    calls, seen = set(), set()
    for e in events:
        if e.get("ph") != "X":
            continue
        ts = float(e["ts"])
        span = (ts, ts + float(e.get("dur", 0)))
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = e.get("args", {}).get("correlation")
        if cat == "cuda_runtime" and name in DEVICE_CALLS:
            if start <= ts <= end:
                calls.add(corr)
            continue
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if not start <= ts <= end:
            continue
        seen.add(corr)
        busy.append(span)
        ms = (span[1] - span[0]) / 1e3
        if cat == "kernel":
            kernels.append(span)
            if any(k in name for k in PORT_KERNELS):
                port_ms += ms
            else:
                other_ms += ms
        for way in copies:
            if cat == "gpu_memcpy" and way in name:
                copies[way].append(span)
                nbytes[way] += int(e.get("args", {}).get("bytes", 0))
    return {"busy_ms": merged_ms(busy), "kernel_ms": merged_ms(kernels),
            "kernels": len(kernels), "port_kernel_ms": port_ms,
            "other_kernel_ms": other_ms,
            "h2d_ms": merged_ms(copies["HtoD"]), "h2d_bytes": nbytes["HtoD"],
            "d2h_ms": merged_ms(copies["DtoH"]), "d2h_bytes": nbytes["DtoH"],
            "device_calls": len(calls), "missing": len(calls - seen)}


def traced_queries(port: int, queries: dict, trace_path: str) -> dict:
    """One more run of each query, all in one torch.profiler session (CPU
    and CUDA activity), each inside a user annotation on this thread;
    returns per query its result, wall ms, launches and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from opengemini_tpu_torch.ops import cuda_segment as cs

    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a session's first device records can go missing from the trace:
        # let small copies and kernels take them
        for _ in range(32):
            torch.ones(8, device="cuda").add_(1).cpu()
        torch.cuda.synchronize()
        for qn, q in queries.items():
            l0 = dict(cs.LAUNCHES)
            with record_function(f"smoke/{qn}"):
                t0 = time.perf_counter()
                res = query(port, q)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            out[qn] = {"result": res, "wall_ms": wall, "launches": {
                k: cs.LAUNCHES[k] - l0[k] for k in l0}}
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith("smoke/") \
                and e.get("cat") == "user_annotation":
            ts = float(e["ts"])
            out[name[6:]]["device"] = device_time(
                events, ts, ts + float(e.get("dur", 0)))
    return out


def phase_e2e(hours: int, seed: int, n_hosts: int = N_HOSTS) -> dict:
    import numpy as np
    import torch

    from opengemini_tpu_torch import convert
    from opengemini_tpu_torch.ingest.line_protocol import series_key
    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.storage.engine import Engine
    from opengemini_tpu_torch.utils.stats import STATS

    n_t = hours * 360
    log(f"[e2e] TSBS cpu-only: {n_hosts} hosts x {len(FIELDS)} fields x "
        f"{hours} h at 10 s = {n_hosts * n_t} rows")
    if hours < 12:
        log(f"[e2e] span cut from 12 h to {hours} h")
    t_gen = time.perf_counter()
    rng = np.random.default_rng(seed)
    tags = host_tags(n_hosts, rng)
    vals = make_values(n_hosts, n_t, rng)
    log(f"[e2e] data generated in {time.perf_counter() - t_gen:.1f} s")

    # from here on the main path runs: every launch counter starts at 0,
    # and each wrapper also records the shapes it is given, per query
    seen: dict = {k: set() for k in cs.LAUNCHES}
    shapes_of = {"now": None}
    originals = {k: getattr(cs, k) for k in cs.LAUNCHES}

    def recorder(name):
        def wrapped(v, *rest_args):
            seen[name].add(tuple(v.shape))
            if shapes_of["now"] is not None:
                shapes_of["now"].setdefault(name, set()).add(tuple(v.shape))
            return originals[name](v, *rest_args)
        return wrapped

    for k in originals:
        setattr(cs, k, recorder(k))
    cs.reset_launches()
    engine = Engine(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "smoke_db"))
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    svc = HttpService(engine, port=0)
    svc.start()
    try:
        status, _ = http(svc.port, "POST", "/query",
                         {"q": "CREATE DATABASE benchmark"})
        check(status == 200, "CREATE DATABASE failed")
        # the first minute of every host as line protocol through /write
        first = 6
        t_load = time.perf_counter()
        lines = []
        for h in range(n_hosts):
            key = series_key("cpu", tags[h])
            for i in range(first):
                fv = ",".join(f"{f}={float(vals[f][h, i])!r}" for f in FIELDS)
                lines.append(f"{key} {fv} {T0_NS + i * STEP_NS}")
        status, _ = http(svc.port, "POST", "/write",
                         {"db": "benchmark", "precision": "ns"},
                         "\n".join(lines).encode())
        check(status == 204, f"/write status {status}")
        del lines
        # the rest through the columnar bulk load
        rest = n_t - first
        times = (T0_NS + np.arange(first, n_t, dtype=np.int64) * STEP_NS)
        table = {
            "series_keys": [series_key("cpu", t) for t in tags],
            "series": np.repeat(np.arange(n_hosts, dtype=np.int64), rest),
            "times": np.tile(times, n_hosts),
            "fields": {f: (np.ascontiguousarray(vals[f][:, first:]).reshape(-1),
                           np.ones(n_hosts * rest, dtype=np.bool_))
                       for f in FIELDS},
        }
        n = convert.load_columnar(engine, "benchmark", {"cpu": table})
        check(n == n_hosts * rest, f"columnar load wrote {n}")
        del table
        log(f"[e2e] loaded in {time.perf_counter() - t_load:.1f} s")

        where = (f"time >= '2016-01-01T00:00:00Z' AND "
                 f"time < '2016-01-01T{hours:02d}:00:00Z'")
        f5 = FIELDS[:5]
        queries = {
            "Q1": "SELECT mean(usage_user), max(usage_user), "
                  f"count(usage_user) FROM cpu WHERE {where} GROUP BY time(1m)",
            "Q2": "SELECT " + ", ".join(f"mean({f})" for f in f5)
                  + f" FROM cpu WHERE {where} GROUP BY time(1h), hostname",
            "Q3": "SELECT " + ", ".join(f"max({f})" for f in f5)
                  + f" FROM cpu WHERE hostname='host_7' AND {where} "
                  "GROUP BY time(1m)",
            "Q4": "SELECT first(usage_user), last(usage_user), "
                  "min(usage_user), max(usage_user), mean(usage_user), "
                  "stddev(usage_user), spread(usage_user) FROM cpu "
                  f"WHERE {where} GROUP BY hostname",
        }
        needs = {"Q1": ("grid_window_agg",), "Q2": ("grid_window_agg",),
                 "Q3": ("grid_window_agg",),
                 "Q4": ("bucket_stats_basic", "bucket_stats_selectors")}
        trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "smoke_trace")
        os.makedirs(trace_dir, exist_ok=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p50, per_query = {}, {}
        for qn, q in queries.items():
            lat = []
            grid0 = STATS["executor/grid_batches"]
            fb0 = STATS["executor/grid_fallbacks"]
            l0 = dict(cs.LAUNCHES)
            shapes_of["now"] = {}
            for _ in range(5):
                t0 = time.perf_counter()
                res = query(svc.port, q)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                verify(qn, res, vals, tags, n_hosts, n_t)
            lat.sort()
            p50[qn] = lat[len(lat) // 2]
            grids = STATS["executor/grid_batches"] - grid0
            fbs = STATS["executor/grid_fallbacks"] - fb0
            got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
            per_query[qn] = {
                "launches": got,
                "shapes": {k: sorted(v) for k, v in shapes_of["now"].items()}}
            if qn != "Q4":
                check(grids > 0 and fbs == 0,
                      f"{qn}: grid_batches +{grids}, fallbacks +{fbs}")
            for k in needs[qn]:
                check(got[k] > 0, f"{qn}: kernel {k} not launched")
            log(f"[e2e] {qn} ok p50={p50[qn]:.1f} ms "
                f"(runs {', '.join(f'{x:.1f}' for x in lat)}) "
                f"grid_batches +{grids}; launches in 5 runs "
                f"{json.dumps(got)} at {json.dumps(per_query[qn]['shapes'])}")
        shapes_of["now"] = None
        # a sixth run of each query under the profiler: where its time goes
        traced = traced_queries(svc.port, queries,
                                os.path.join(trace_dir, "queries.json"))
        for qn, tr in traced.items():
            verify(qn, tr.pop("result"), vals, tags, n_hosts, n_t)
            dev, wall = tr.get("device"), tr["wall_ms"]
            check(dev is not None, f"{qn}: no annotation in the trace")
            if dev["busy_ms"] == 0.0:
                log(f"[trace] {qn} wall {wall:.1f} ms: the trace holds no "
                    "device activity (device time not measured)")
                continue
            log(f"[trace] {qn} wall {wall:.1f} ms, device busy "
                f"{dev['busy_ms']:.3f} ms ({100 * dev['busy_ms'] / wall:.3f}% "
                f"of the wall), kernels {dev['kernel_ms']:.3f} ms "
                f"({dev['kernels']} kernels: port {dev['port_kernel_ms']:.3f} "
                f"ms, others {dev['other_kernel_ms']:.3f} ms), host-to-device "
                f"{dev['h2d_ms']:.3f} ms for {dev['h2d_bytes']} B, "
                f"device-to-host {dev['d2h_ms']:.3f} ms for {dev['d2h_bytes']}"
                f" B; {dev['device_calls']} device calls, "
                f"{dev['missing']} without a device record; launches "
                f"{json.dumps(tr['launches'])}")
        launches = dict(cs.LAUNCHES)
        for k, cnt in launches.items():
            check(cnt > 0, f"kernel {k} never launched on the main path")
        peak = torch.cuda.max_memory_allocated()
        log(f"[e2e] launches (5 timed + 1 traced run per query) {launches}; "
            f"device memory peak {peak / 2**20:.1f} MiB; p50 ms "
            f"{json.dumps(p50)}; card {smi_line()}")
        return {"launches": launches, "shapes": seen, "p50_ms": p50,
                "per_query": per_query, "traced": traced, "peak_bytes": peak}
    finally:
        svc.stop()
        for k, fn in originals.items():
            setattr(cs, k, fn)


def verify(qn: str, res: dict, vals, tags, n_hosts: int, n_t: int) -> None:
    import numpy as np

    series = res.get("series", [])
    if qn == "Q1":
        check(len(series) == 1, "Q1: one series")
        rows = series[0]["values"]
        v = vals["usage_user"].reshape(n_hosts, n_t // 6, 6)
        check(len(rows) == n_t // 6, "Q1: window count")
        times = [r[0] for r in rows]
        check(times == [T0_NS + w * 60 * 10**9 for w in range(n_t // 6)],
              "Q1: window times")
        cnt = np.array([r[3] for r in rows])
        check((cnt == n_hosts * 6).all(), "Q1: counts")
        check(np.array_equal(np.array([r[2] for r in rows]),
                             v.max(axis=(0, 2))), "Q1: max")
        check(close([r[1] for r in rows], v.sum(axis=(0, 2)) / (n_hosts * 6)),
              "Q1: mean")
    elif qn == "Q2":
        check(len(series) == n_hosts, "Q2: one series per host")
        for s in series:
            h = int(s["tags"]["hostname"].split("_")[1])
            rows = s["values"]
            check(len(rows) == n_t // 360, f"Q2 host {h}: window count")
            for j, f in enumerate(FIELDS[:5]):
                want = vals[f][h].reshape(n_t // 360, 360).mean(axis=1)
                check(close([r[1 + j] for r in rows], want),
                      f"Q2 host {h}: mean({f})")
    elif qn == "Q3":
        check(len(series) == 1, "Q3: one series")
        rows = series[0]["values"]
        for j, f in enumerate(FIELDS[:5]):
            want = vals[f][7].reshape(n_t // 6, 6).max(axis=1)
            check(np.array_equal(np.array([r[1 + j] for r in rows]), want),
                  f"Q3: max({f})")
    else:
        check(len(series) == n_hosts, "Q4: one series per host")
        v = vals["usage_user"]
        for s in series:
            h = int(s["tags"]["hostname"].split("_")[1])
            (row,) = s["values"]
            _t, fst, lst, mn, mx, mean, sd, spread = row
            x = v[h]
            check(fst == x[0] and lst == x[-1], f"Q4 host {h}: first/last")
            check(mn == x.min() and mx == x.max(), f"Q4 host {h}: min/max")
            check(spread == x.max() - x.min(), f"Q4 host {h}: spread")
            check(close([mean], [x.mean()]), f"Q4 host {h}: mean")
            check(close([sd], [x.std(ddof=1)]), f"Q4 host {h}: stddev")


# -- main ---------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hours", type=int, default=12,
                    help="span of the end-to-end data (cut only to fit a "
                         "time limit, never below 3)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if args.hours < 3:
        ap.error("--hours may not be cut below 3")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from opengemini_tpu_torch.ops import cuda_segment as cs

    t_start = time.perf_counter()
    dev_name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {dev_name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cs.build(verbose=True)
    log(f"[build] 3 kernels built in {time.perf_counter() - t0:.1f} s "
        f"into {cs.BUILD_DIR}")

    checked = phase_kernels(dev_name, args.seed)
    e2e = phase_e2e(args.hours, args.seed)

    kernels = []
    for i, name in enumerate(cs.LAUNCHES):
        recs = []
        for j, shape in enumerate(sorted(e2e["shapes"][name])):
            rec = kernel_case(name, shape, args.seed + 1000 + 10 * i + j,
                              dev_name, timed=True)
            recs.append(rec)
            log(f"[main-path kernel] {name}{tuple(shape)} ok "
                f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                f"bound_ms={rec['bound_ms']:.4f}")
        top = max(recs, key=lambda r: r["bound_ms"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(cs.source_path(name),
                                      os.path.dirname(os.path.abspath(__file__))),
            "replaces": REPLACES[name],
            "launches": e2e["launches"][name],
            "launches_per_query": {qn: pq["launches"][name]
                                   for qn, pq in e2e["per_query"].items()},
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
            "shape": top["shape"],
            "main_path_shapes": recs,
            "checked_shapes": checked[name],
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
