"""One rank of the port's mesh across processes, on the CPU.

    python tests/torch_multiproc_worker.py <job.json>

tests/test_torch_multiproc.py starts one of these per rank. Each builds
the port's ts-server (``server/app.build``) from a config whose
``[device]`` section names the coordinator, the number of processes
and its process id, so that it joins a gloo process group and lays its
share of a global mesh on the CPU; loads the same seeded writes into its
own root; answers the C1-, C3-, B1-, A1- and PQ3-like queries through
the Executor (or the PromEngine) and through its own HttpService, every
rank in the same order; and writes its answers, its place in the mesh
and its collectives' counts to the job's output file. Steps a job may
add: ``reload`` (the [device] mesh 4 -> 2 -> off -> 4 through
``_apply_mesh_config``, C1 after each, with the device tier's bytes) and
``out_of_step`` (rank 0 runs one more mesh query than the others).

The data and the queries are functions of this module that import only
numpy, so that the tests (and the JAX package's own processes) build the
same writes. The module imports neither jax nor the JAX package.
"""

import json
import os
import sys
import time
import urllib.parse
import urllib.request

import numpy as np

NS = 10**9
BASE = 1_700_000_040
N_HOSTS = 70
N_PTS = 110
STEP_S = 10
LO, HI = BASE * NS, (BASE + N_PTS * STEP_S) * NS
WHERE = f"time >= {LO} AND time < {HI}"

# C1 and C3 take the grid layout (the fused decode of cold blocks per
# shard), B1 the bucketed one; A1 holds a rank-based aggregate, so its
# batch is the AggBatch, whose mesh aggregates merge with collectives
QUERIES = {
    "C1": "SELECT mean(usage_user), max(usage_user), count(usage_user) "
          f"FROM cpu WHERE {WHERE} GROUP BY time(1m)",
    "C3": "SELECT count(read_bytes), min(read_bytes), max(read_bytes) "
          f"FROM diskio WHERE {WHERE} GROUP BY time(1m)",
    "B1": "SELECT first(usage_user), last(usage_user), min(usage_user), "
          "max(usage_user), mean(usage_user), stddev(usage_user), "
          f"spread(usage_user) FROM cpu WHERE {WHERE} GROUP BY host",
    "A1": "SELECT median(usage_user), first(usage_user), "
          "last(usage_user), min(usage_user), max(usage_user), "
          f"mean(usage_user), count(usage_user) FROM cpu WHERE {WHERE} "
          "GROUP BY time(5m)",
}
# PQ3-like: the tiled PromQL kernels with their series axis sharded
PROM = {
    "PQ3": ("avg by (host) (avg_over_time(reqs[1m]))",
            BASE + 120, BASE + (N_PTS - 1) * STEP_S, 60),
}


def lines() -> str:
    """The writes every rank loads: every host samples at the same
    instants, and usage_user takes few values, so first/last/min/max tie
    across hosts (and so across shards and ranks) at equal times."""
    rng = np.random.default_rng(19)
    usage = rng.integers(0, 6, size=(N_HOSTS, N_PTS)) * 0.5
    rbytes = rng.integers(0, 250, size=(N_HOSTS, N_PTS))
    reqs = np.cumsum(rng.random((N_HOSTS, N_PTS)), axis=1)
    out = []
    for p in range(N_PTS):
        t = (BASE + p * STEP_S) * NS
        for h in range(N_HOSTS):
            out.append(f"cpu,host=h{h} usage_user={usage[h, p]} {t}")
            out.append(f"diskio,host=h{h} read_bytes={rbytes[h, p]}i {t}")
            out.append(f"reqs,host=h{h} value={float(reqs[h, p])!r} {t}")
    return "\n".join(out)


def load(engine) -> None:
    """The writes into `engine`, flushed to device-decodable files."""
    engine.create_database("db")
    engine.write_lines("db", lines())
    engine.flush_all()


def _get(port: int, path: str, params: dict) -> dict:
    url = f"http://127.0.0.1:{port}{path}?" + urllib.parse.urlencode(params)
    with urllib.request.urlopen(url, timeout=300) as r:
        return json.loads(r.read())


def answer(svc, qn: str) -> dict:
    """One query's answers on this rank: the Executor's (or the
    PromEngine's) and the HttpService's."""
    if qn in PROM:
        q, start, end, step = PROM[qn]
        direct = svc.prom.query_range(q, start, end, step, db="db")
        http = _get(svc.port, "/api/v1/query_range",
                    {"query": q, "start": start, "end": end, "step": step,
                     "db": "db"})["data"]
        return {"direct": direct, "http": http}
    direct = svc.executor.execute(QUERIES[qn], db="db")
    http = _get(svc.port, "/query",
                {"q": QUERIES[qn], "db": "db", "epoch": "ns"})
    return {"direct": direct, "http": http}


def main(job_path: str) -> None:
    with open(job_path, encoding="utf-8") as f:
        job = json.load(f)
    os.environ["OGT_DEVICE_PROFILE"] = "1"
    os.environ["OGT_DEVICE_DECODE"] = "1"
    os.environ["OGT_RESULT_CACHE"] = "0"
    os.environ["OGT_DIST_TIMEOUT_S"] = str(job["timeout_s"])
    import torch

    from opengemini_tpu_torch.parallel import distributed, runtime
    from opengemini_tpu_torch.server import app
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.utils import devobs

    torch.set_num_threads(1)
    rank = job["rank"]
    dev_cfg = {"mesh-axes": ["shard"], "mesh-devices": job["shards"],
               "coordinator-address": f"127.0.0.1:{job['port']}",
               "num-processes": job["world"], "process-id": rank}
    cfg = {"data": {"dir": job["root"]},
           "http": {"bind-address": "127.0.0.1:0"},
           "services": {"store-monitor": False},
           "device": dev_cfg}
    out = {"rank": rank}
    svc = app.build(cfg, device="cpu")
    svc.start()
    try:
        world, mesh = runtime.get_world(), runtime.get_mesh()
        out["world"] = {"rank": world.rank, "size": world.size,
                        "backend": world.backend}
        out["mesh"] = {"size": mesh.size, "local_shards": mesh.local_shards,
                       "shard_ranks": mesh.shard_ranks}
        colcache.GLOBAL.configure(budget_mb=64, device=True,
                                  device_budget_mb=64)
        load(svc.engine)
        out["answers"] = {}
        for qn in job["queries"]:
            out["answers"][qn] = answer(svc, qn)
        if "reload" in job["steps"]:
            out["reload"] = []
            for n in (2, None, 4):
                step = ({} if n is None else
                        {"mesh-axes": ["shard"], "mesh-devices": n})
                c0 = colcache.GLOBAL.counters()
                changed = app._apply_mesh_config(step, "cpu")
                res = svc.executor.execute(QUERIES["C1"], db="db")
                c1 = colcache.GLOBAL.counters()
                cur = runtime.get_mesh()
                out["reload"].append({
                    "changed": changed, "answer": res,
                    "size": None if cur is None else cur.size,
                    "local_shards": None if cur is None
                    else cur.local_shards,
                    "reshards": c1["device_reshards"]
                    - c0["device_reshards"],
                    "hits": c1["device_hits"] - c0["device_hits"],
                    "device_bytes": colcache.GLOBAL.device_ledger_bytes()})
        out["debug_mesh"] = devobs.debug_doc()["mesh"]
        out["collectives"] = distributed.collective_stats()
        if "out_of_step" in job["steps"]:
            if rank == 0:
                t0 = time.monotonic()
                try:
                    svc.executor.execute(QUERIES["A1"], db="db")
                    raised = None
                except RuntimeError as e:
                    raised = str(e)
                out["out_of_step"] = {"raised": raised,
                                      "wall_s": time.monotonic() - t0}
            else:
                # idle until rank 0 has raised (its output file), at most
                # twice the group's timeout, then leave
                done = os.path.join(os.path.dirname(job["out"]), "out0.json")
                end = time.monotonic() + 2 * job["timeout_s"]
                while not os.path.exists(done) and time.monotonic() < end:
                    time.sleep(0.2)
    except BaseException as e:  # noqa: BLE001 — the test reads it
        out["error"] = f"{type(e).__name__}: {e}"
    with open(job["out"] + ".tmp", "w", encoding="utf-8") as f:
        json.dump(out, f)
    os.replace(job["out"] + ".tmp", job["out"])
    sys.stdout.flush()
    # the process group, the HTTP server and the services' threads end
    # with the process
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1])
