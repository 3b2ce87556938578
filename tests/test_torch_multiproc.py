"""The port's mesh across processes (ROADMAP A8.4) on the CPU.

tests/torch_multiproc_worker.py ranks, started as the port's ts-server
with the ``[device]`` keys coordinator-address, num-processes and
process-id and ``-device cpu`` (gloo), each laying its share of a global
mesh on the CPU: 2 ranks of 2 shards (4 in all) and 4 ranks of 2 (8 in
all). Every rank loads the same seeded writes into its own root and
answers C1- and C3-like grid queries (the fused decode of each rank's
own shards' blocks), a B1-like bucketed one, an A1-like AggBatch one
(whose merges are collectives) and a PQ3-like PromQL range query (the
tiled kernels), through the Executor and through its HttpService. Each
answer must equal the port's one-process mesh of the same shard count
and the JAX package's one-process mesh (tests/conftest.py's 8 CPU
devices): exactly for counts, extremes and first/last (their ties cross
the rank boundary: every host samples at the same instants, on few
values), within rel 1e-9 for means, sums and standard deviations.

The JAX package itself runs in 2 processes (tests/jax_multiproc_worker.py,
``jax.distributed.initialize`` with gloo CPU collectives, 2 host devices
each): its AggBatch path answers as the port does; its dense grid,
bucketed and tiled PromQL paths raise at the fetch of a row-sharded
result that spans another process's devices (ROADMAP C), where the port
answers as the reference's one-process mesh.

Also: a [device] reload 4 -> 2 -> off -> 4 on both ranks of a world of
2 (the device tier's entry reshards over the process group, and a
rank's resident bytes never grow), and a rank out of step (one more
mesh query on rank 0 alone) raising within the group's timeout. Every
job starts at once in the module's fixture; each picks its rendezvous
port by binding port 0.
"""

import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from opengemini_tpu import native as jnative
from opengemini_tpu.parallel import distributed as jdist
from opengemini_tpu.parallel import runtime as jrt
from opengemini_tpu.promql.engine import PromEngine as JPromEngine
from opengemini_tpu.query import offload as joffload
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.parallel import distributed as tdist
from opengemini_tpu_torch.parallel import runtime as trt
from opengemini_tpu_torch.promql.engine import PromEngine as TPromEngine
from opengemini_tpu_torch.query import offload as toffload
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage.engine import Engine as TEngine

import torch_multiproc_worker as W

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RTOL = 1e-9
# columns merged by adding: within RTOL; every other number exactly
SUMMED = {"mean", "sum", "stddev"}
QNAMES = ("C1", "C3", "B1", "A1", "PQ3")
WORLDS = {2: 4, 4: 8}  # processes: global shards (2 a rank)
# the out-of-step pair's group timeout (s): above the skew of the
# ranks' loads under a loaded host, which the first, in-step query waits
# out
STEP_TIMEOUT_S = 25.0
JOB_LIMIT_S = 240.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(script: str, d: str, world: int, job: dict) -> list:
    """`world` processes of `script`, one job file each."""
    os.makedirs(d, exist_ok=True)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    procs = []
    for r in range(world):
        spec = dict(job, rank=r, world=world, port=port, dir=d,
                    root=os.path.join(d, f"root{r}"),
                    out=os.path.join(d, f"out{r}.json"))
        path = os.path.join(d, f"job{r}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        log = open(os.path.join(d, f"log{r}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, script), path], cwd=REPO,
            env=env, stdout=log, stderr=subprocess.STDOUT), spec["out"], log))
    return procs


def _finish(procs) -> list:
    outs = []
    deadline = time.monotonic() + JOB_LIMIT_S
    for p, out, log in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        with open(out, encoding="utf-8") as f:
            outs.append(json.load(f))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process job, started together: the port in 2 and 4
    ranks (the 2-rank job also reloads its mesh), the out-of-step pair,
    and the JAX package in 2 processes."""
    base = str(tmp_path_factory.mktemp("multiproc"))
    jobs = {}
    for world, shards in WORLDS.items():
        jobs[world] = _start(
            "torch_multiproc_worker.py", os.path.join(base, f"w{world}"),
            world, {"shards": shards, "queries": list(QNAMES),
                    "steps": ["reload"] if world == 2 else [],
                    "timeout_s": 120.0})
    jobs["step"] = _start(
        "torch_multiproc_worker.py", os.path.join(base, "step"), 2,
        {"shards": 2, "queries": ["A1"], "steps": ["out_of_step"],
         "timeout_s": STEP_TIMEOUT_S})
    jobs["jax"] = _start(
        "jax_multiproc_worker.py", os.path.join(base, "jax"), 2,
        {"devices": 2, "queries": list(QNAMES)})
    return {k: _finish(v) for k, v in jobs.items()}


def _answers(ex, prom):
    out = {}
    for qn in QNAMES:
        if qn in W.PROM:
            q, start, end, step = W.PROM[qn]
            out[qn] = prom.query_range(q, start, end, step, db="db")
        else:
            out[qn] = ex.execute(W.QUERIES[qn], db="db")
    return json.loads(json.dumps(out))


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """{shards: (the port's one-process mesh answers, the JAX package's
    one-process mesh answers)} over the same writes."""
    d = tmp_path_factory.mktemp("oneproc")
    keep = {k: os.environ.get(k) for k in
            ("OGT_DEVICE_PROFILE", "OGT_DEVICE_DECODE", "OGT_RESULT_CACHE")}
    os.environ.update(OGT_DEVICE_PROFILE="1", OGT_DEVICE_DECODE="1",
                      OGT_RESULT_CACHE="0")
    if jnative.load() is None:
        assert jnative.build(), "g++ build of native/codecs.cpp failed"
    te = TEngine(str(d / "t"), device="cpu")
    je = JEngine(str(d / "j"))
    try:
        for e in (te, je):
            W.load(e)
        tx, tp = TExecutor(te), TPromEngine(te)
        jx, jp = JExecutor(je), JPromEngine(je)
        got = {}
        for shards in sorted(set(WORLDS.values())):
            trt.set_mesh(tdist.make_mesh(shards, devices=["cpu"] * shards))
            jrt.set_mesh(jdist.make_mesh(shards))
            try:
                got[shards] = (_answers(tx, tp), _answers(jx, jp))
            finally:
                trt.set_mesh(None)
                jrt.set_mesh(None)
        return got
    finally:
        te.close()
        je.close()
        joffload.reset()
        toffload.reset()
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _same(got, want, col: str = "", what: str = "") -> None:
    """Equal answers: every number exactly, but a merged sum's columns
    (and PromQL's averages) within RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), what
        if "columns" in want and "values" in want:
            assert got["columns"] == want["columns"], what
            assert len(got["values"]) == len(want["values"]), what
            for gr, wr in zip(got["values"], want["values"]):
                for c, g, w in zip(want["columns"], gr, wr):
                    _same(g, w, c, what)
            rest = set(want) - {"columns", "values"}
            for k in rest:
                _same(got[k], want[k], col, what)
            return
        for k in want:
            _same(got[k], want[k], "value" if k == "values" else col, what)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for g, w in zip(got, want):
            _same(g, w, col, what)
    elif col in SUMMED or (col == "value" and isinstance(want, str)):
        a, b = float(got), float(want)
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0), (what, col, a, b)
    else:
        assert got == want, (what, col, got, want)


@pytest.mark.parametrize("qn", QNAMES)
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_every_rank_answers_as_one_process_and_jax(runs, one_process,
                                                   world, qn):
    solo, jax_solo = one_process[WORLDS[world]]
    _same(solo[qn], jax_solo[qn], what=f"{qn}: port against JAX, one "
                                       "process")
    assert "error" not in json.dumps(solo[qn]), solo[qn]
    for out in runs[world]:
        assert "error" not in out, out.get("error")
        got = out["answers"][qn]
        for route in ("direct", "http"):
            _same(got[route], solo[qn],
                  what=f"{qn} rank {out['rank']}/{world} ({route})")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_each_rank_holds_its_own_shards(runs, world):
    shards = WORLDS[world]
    per = shards // world
    calls = set()
    for out in runs[world]:
        r = out["rank"]
        assert out["world"] == {"rank": r, "size": world, "backend": "gloo"}
        assert out["mesh"]["size"] == shards
        assert out["mesh"]["shard_ranks"] == [s // per
                                              for s in range(shards)]
        assert out["mesh"]["local_shards"] == list(range(r * per,
                                                         (r + 1) * per))
        doc = out["debug_mesh"]
        assert doc["process_id"] == r and doc["num_processes"] == world
        assert doc["backend"] == "gloo" and doc["size"] == shards
        assert doc["local_shards"] == out["mesh"]["local_shards"]
        assert doc["collectives"]["calls"] == out["collectives"]["calls"]
        calls.add(out["collectives"]["calls"])
        assert out["collectives"]["bytes"] > 0
    # every rank issued the same collectives
    assert len(calls) == 1 and calls.pop() > 0


def test_reload_reshards_across_the_ranks(runs, one_process):
    solo = one_process[WORLDS[2]][0]["C1"]
    first = None
    for out in runs[2]:
        r = out["rank"]
        steps = out["reload"]
        assert [s["size"] for s in steps] == [2, None, 4]
        assert [s["local_shards"] for s in steps] == [
            [r], None, [2 * r, 2 * r + 1]]
        for s in steps:
            assert s["changed"], s
            _same(json.loads(json.dumps(s["answer"])), solo,
                  what=f"C1 after the reload to {s['size']} on rank {r}")
            # the retained grid moved to the new layout, over the group
            assert s["reshards"] == 1 and s["hits"] >= 1, s
        held = [s["device_bytes"] for s in steps]
        # one shard of 4 rows' share, then all of them, then two again:
        # a rank holds its own shards only, and a reload never doubles
        # what it holds
        assert held[0] < held[1] and held[2] < held[1], held
        first = held if first is None else first
        assert held == first  # the ranks hold alike


def test_a_rank_out_of_step_raises_within_the_timeout(runs):
    r0, r1 = sorted(runs["step"], key=lambda o: o["rank"])
    assert "error" not in r0 and "error" not in r1
    # in step, the pair answered
    assert "error" not in json.dumps(r0["answers"]["A1"]["direct"])
    got = r0["out_of_step"]
    assert got["raised"] and "Timed out" in got["raised"], got
    assert STEP_TIMEOUT_S - 1 < got["wall_s"] < STEP_TIMEOUT_S + 15, got


def test_the_reference_in_processes(runs, one_process):
    """The JAX package over 2 processes (a global mesh of 4 host
    devices): the AggBatch path's replicated outputs answer, equal to
    the port's ranks; the row-sharded fetches of the grid, bucketed and
    tiled PromQL paths raise (ROADMAP C)."""
    solo = one_process[4][0]
    for out in runs["jax"]:
        assert out["devices"] == 4 and out["local_devices"] == 2
        got = out["answers"]
        _same(got["A1"], solo["A1"], what="A1 in the JAX package's "
                                          f"process {out['rank']}")
        for qn in ("C1", "C3", "B1", "PQ3"):
            raised = got[qn].get("raised", "")
            assert raised.startswith("RuntimeError: Fetching value for "
                                     "`jax.Array` that spans "
                                     "non-addressable"), (qn, got[qn])


def test_a_world_of_one_runs_every_collective(tmp_path):
    """One process in a gloo group of one, as one process on one card is
    under NCCL: the mesh is global, and the collectives of a merge, a
    gather and a reshard all run."""
    import torch.distributed as tdistributed

    port = _free_port()
    tdistributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    trt.set_world(trt.World(0, 1, tdistributed.group.WORLD, "gloo",
                            torch.device("cpu")))
    try:
        c0 = tdist.collective_stats()["calls"]
        mesh = tdist.make_mesh(2, devices=["cpu"] * 2)
        assert mesh.world is not None and mesh.local_shards == [0, 1]
        rng = np.random.default_rng(3)
        n, g = 101, 7
        v = np.round(rng.random(n) * 4) / 2
        hi = np.zeros(n, np.int32)
        lo = (np.arange(n) // 10).astype(np.int32)
        sid = rng.integers(0, g, n).astype(np.int32)
        m = rng.random(n) > 0.1
        gidx = np.arange(n, dtype=np.int32)
        sh = tdist.shard_rows(mesh, v, hi, lo, sid, m, gidx)
        got = tdist.build_batch_agg(mesh, g, ("first", "max"))(*sh)
        trt.set_world(None)
        plain = tdist.make_mesh(2, devices=["cpu"] * 2)
        want = tdist.build_batch_agg(plain, g, ("first", "max"))(
            *tdist.shard_rows(plain, v, hi, lo, sid, m, gidx))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
        trt.set_world(mesh.world)
        np.testing.assert_array_equal(sh[0].gather().numpy(),
                                      np.concatenate([v, [0.0]]))
        (one,) = tdist.donate_reshard(tdist.make_mesh(
            1, devices=["cpu"]), sh[0])
        np.testing.assert_array_equal(tdist.fetch_np(one),
                                      np.concatenate([v, [0.0]]))
        assert tdist.collective_stats()["calls"] > c0
    finally:
        trt.set_world(None)
        tdistributed.destroy_process_group()
