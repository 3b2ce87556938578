"""One process of the JAX package's own mesh across processes, on the CPU.

    python tests/jax_multiproc_worker.py <job.json>

The reference's multi-process model (opengemini_tpu/server/app.py
``_init_jax_distributed``): ``jax.distributed.initialize`` with gloo
CPU collectives and ``devices`` host devices a process, so that
``jax.devices()`` spans every process and ``make_mesh()`` is global.
Each process loads tests/torch_multiproc_worker.py's writes into its
own root and runs its queries over the global mesh; an answer, or the
error the reference raises, goes to the job's output file for
tests/test_torch_multiproc.py.
"""

import json
import os
import sys
import tempfile
import time


def main(job_path: str) -> None:
    with open(job_path, encoding="utf-8") as f:
        job = json.load(f)
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={job['devices']}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(f"127.0.0.1:{job['port']}", job["world"],
                               job["rank"])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_multiproc_worker as W
    from opengemini_tpu.parallel import distributed, runtime
    from opengemini_tpu.promql.engine import PromEngine
    from opengemini_tpu.query.executor import Executor
    from opengemini_tpu.storage.engine import Engine

    out = {"rank": job["rank"], "devices": len(jax.devices()),
           "local_devices": len(jax.local_devices()), "answers": {}}
    engine = Engine(tempfile.mkdtemp(dir=job["dir"]))
    W.load(engine)
    ex, prom = Executor(engine), PromEngine(engine)
    runtime.set_mesh(distributed.make_mesh())
    for qn in job["queries"]:
        try:
            if qn in W.PROM:
                q, start, end, step = W.PROM[qn]
                got = prom.query_range(q, start, end, step, db="db")
            else:
                got = ex.execute(W.QUERIES[qn], db="db")
        except Exception as e:  # noqa: BLE001 — the reference's error
            got = {"raised": f"{type(e).__name__}: {e}"}
        out["answers"][qn] = got
    with open(job["out"] + ".tmp", "w", encoding="utf-8") as f:
        json.dump(out, f, default=str)
    os.replace(job["out"] + ".tmp", job["out"])
    sys.stdout.flush()
    # process 0 hosts the coordination service, whose end terminates the
    # others: it leaves once every process has written its answers
    if job["rank"] == 0:
        end = time.monotonic() + 120
        others = [os.path.join(job["dir"], f"out{r}.json")
                  for r in range(1, job["world"])]
        while (not all(map(os.path.exists, others))
               and time.monotonic() < end):
            time.sleep(0.2)
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1])
