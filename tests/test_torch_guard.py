"""The PyTorch port stands alone: no JAX, nothing of opengemini_tpu, and
entry points that default to the CUDA card.

The import check runs in a subprocess, because this test process has
already imported jax (tests/conftest.py)."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import opengemini_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules() -> list[str]:
    names = ["opengemini_tpu_torch"]
    for info in pkgutil.walk_packages(opengemini_tpu_torch.__path__,
                                      "opengemini_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_is_found():
    mods = _port_modules()
    for must in ("opengemini_tpu_torch.ops.cuda_segment",
                 "opengemini_tpu_torch.query.executor",
                 "opengemini_tpu_torch.server.http",
                 "opengemini_tpu_torch.convert",
                 *SIXTH_SLICE_MODULES, *SEVENTH_SLICE_MODULES,
                 *EIGHTH_SLICE_MODULES, *NINTH_SLICE_MODULES,
                 *TENTH_SLICE_MODULES, *ELEVENTH_SLICE_MODULES,
                 *TWELFTH_SLICE_MODULES, *THIRTEENTH_SLICE_MODULES,
                 *FOURTEENTH_SLICE_MODULES, *FIFTEENTH_SLICE_MODULES,
                 *SEVENTEENTH_SLICE_MODULES, *EIGHTEENTH_SLICE_MODULES):
        assert must in mods


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
        "or m == 'opengemini_tpu' or m.startswith('opengemini_tpu.'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_engine_defaults_to_cuda_and_never_falls_back(tmp_path):
    from opengemini_tpu_torch.query.executor import Executor
    from opengemini_tpu_torch.storage.engine import Engine

    if torch.cuda.is_available():
        eng = Engine(str(tmp_path))
        assert eng.device.type == "cuda"
        assert Executor(eng).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(str(tmp_path), device="cuda")
    eng = Engine(str(tmp_path), device="cpu")
    assert eng.device.type == "cpu"
    assert Executor(eng).device.type == "cpu"


def test_compute_dtype_is_float64():
    import numpy as np

    from opengemini_tpu_torch.models import templates

    assert templates.compute_dtype() == np.dtype(np.float64)


# the modules of the cold-scan slice (and the smoke script that drives
# them): each imports with jax and the JAX package made unimportable
BLOCKED_IMPORT_MODULES = [
    "opengemini_tpu_torch.native",
    "opengemini_tpu_torch.ingest.native_lp",
    "opengemini_tpu_torch.storage.encoding",
    "opengemini_tpu_torch.storage.chunkmeta",
    "opengemini_tpu_torch.storage.encodepool",
    "opengemini_tpu_torch.storage.scanpool",
    "opengemini_tpu_torch.storage.tsf",
    "opengemini_tpu_torch.storage.wal",
    "opengemini_tpu_torch.index.mergeset",
    "opengemini_tpu_torch.storage.shard",
    "opengemini_tpu_torch.storage.engine",
    "opengemini_tpu_torch.utils.devobs",
    "opengemini_tpu_torch.query.offload",
    "opengemini_tpu_torch.ops.device_decode",
    "opengemini_tpu_torch.models.grid",
    "opengemini_tpu_torch.query.executor",
    "opengemini_tpu_torch.convert",
    "chip_smoke",
]
# the modules of the stage-timing, native-parser, cache and compaction
# slice
SIXTH_SLICE_MODULES = [
    "opengemini_tpu_torch.utils.stats",
    "opengemini_tpu_torch.utils.tracing",
    "opengemini_tpu_torch.utils.errno",
    "opengemini_tpu_torch.utils.querytracker",
    "opengemini_tpu_torch.storage.colcache",
    "opengemini_tpu_torch.services",
    "opengemini_tpu_torch.services.base",
    "opengemini_tpu_torch.services.compaction",
    "opengemini_tpu_torch.server.http",
]
BLOCKED_IMPORT_MODULES += SIXTH_SLICE_MODULES

# the host query path and the schema statements
SEVENTH_SLICE_MODULES = [
    "opengemini_tpu_torch.query.functions",
    "opengemini_tpu_torch.query.hostpath",
    "opengemini_tpu_torch.query.showddl",
]
BLOCKED_IMPORT_MODULES += SEVENTH_SLICE_MODULES

# subqueries, joins, unions, CTEs and SELECT INTO
EIGHTH_SLICE_MODULES = [
    "opengemini_tpu_torch.query.subquery",
    "opengemini_tpu_torch.query.join",
]
BLOCKED_IMPORT_MODULES += EIGHTH_SLICE_MODULES
NINTH_SLICE_MODULES = [
    "opengemini_tpu_torch.query.resultcache",
    "opengemini_tpu_torch.query.sketch",
    "opengemini_tpu_torch.query.tablefunc",
    "opengemini_tpu_torch.utils.querytracker",
]
BLOCKED_IMPORT_MODULES += NINTH_SLICE_MODULES
# the data lifecycle and media damage: failpoints, disk faults, the sid
# bloom, the text index and the modules the delete rewrite, quarantine
# and match() pruning changed
TENTH_SLICE_MODULES = [
    "opengemini_tpu_torch.utils.failpoint",
    "opengemini_tpu_torch.storage.diskfault",
    "opengemini_tpu_torch.utils.bloom",
    "opengemini_tpu_torch.native.textindex",
    "opengemini_tpu_torch.storage.shard",
    "opengemini_tpu_torch.storage.engine",
    "opengemini_tpu_torch.query.condition",
    "opengemini_tpu_torch.query.qhelpers",
]
BLOCKED_IMPORT_MODULES += TENTH_SLICE_MODULES
# the single-node HTTP surface (/metrics, /api/v2/write, the syscontrol
# switches) and the offload planner with device observability, with the
# modules whose sites feed them
ELEVENTH_SLICE_MODULES = [
    "opengemini_tpu_torch.utils.stats",
    "opengemini_tpu_torch.utils.devobs",
    "opengemini_tpu_torch.query.offload",
    "opengemini_tpu_torch.server.http",
    "opengemini_tpu_torch.ops.device_decode",
    "opengemini_tpu_torch.ops.cuda_segment",
    "opengemini_tpu_torch.models.grid",
    "opengemini_tpu_torch.models.templates",
    "opengemini_tpu_torch.models.ragged",
    "opengemini_tpu_torch.storage.colcache",
]
BLOCKED_IMPORT_MODULES += ELEVENTH_SLICE_MODULES
# PromQL: the parser and engine, the range kernels, the label tier, the
# remote write/read and OTLP codecs, and the modules they changed
TWELFTH_SLICE_MODULES = [
    "opengemini_tpu_torch.promql",
    "opengemini_tpu_torch.promql.parser",
    "opengemini_tpu_torch.promql.engine",
    "opengemini_tpu_torch.ops.prom",
    "opengemini_tpu_torch.ops.segment",
    "opengemini_tpu_torch.index.labels",
    "opengemini_tpu_torch.index.mergeset",
    "opengemini_tpu_torch.ingest.protowire",
    "opengemini_tpu_torch.ingest.prom_remote",
    "opengemini_tpu_torch.ingest.otlp",
    "opengemini_tpu_torch.query.condition",
    "opengemini_tpu_torch.ops.device_decode",
    "opengemini_tpu_torch.server.http",
]
BLOCKED_IMPORT_MODULES += TWELFTH_SLICE_MODULES

# the continuous tier under the resource governor and the slow log
THIRTEENTH_SLICE_MODULES = [
    "opengemini_tpu_torch.utils.slowlog",
    "opengemini_tpu_torch.utils.governor",
    "opengemini_tpu_torch.services.iodetector",
    "opengemini_tpu_torch.services.retention",
    "opengemini_tpu_torch.services.downsample",
    "opengemini_tpu_torch.services.rollup",
    "opengemini_tpu_torch.services.continuous",
    "opengemini_tpu_torch.services.stream",
    "opengemini_tpu_torch.storage.downsample",
    "opengemini_tpu_torch.storage.rollup",
    "opengemini_tpu_torch.query.rollupplan",
]
BLOCKED_IMPORT_MODULES += THIRTEENTH_SLICE_MODULES

# the rule engine and the operations tier: castor, subscriptions, the
# scrub, sherlock, the monitor, hierarchical storage, the durability
# ledger, and the modules they changed
FOURTEENTH_SLICE_MODULES = [
    "opengemini_tpu_torch.promql.rules",
    "opengemini_tpu_torch.services.rules",
    "opengemini_tpu_torch.services.castor",
    "opengemini_tpu_torch.services.subscriber",
    "opengemini_tpu_torch.services.scrub",
    "opengemini_tpu_torch.services.sherlock",
    "opengemini_tpu_torch.services.monitor",
    "opengemini_tpu_torch.services.hierarchical",
    "opengemini_tpu_torch.ops.prom",
    "opengemini_tpu_torch.storage.shard",
    "opengemini_tpu_torch.storage.engine",
    "opengemini_tpu_torch.query.functions",
    "opengemini_tpu_torch.query.hostpath",
    "opengemini_tpu_torch.query.showddl",
    "opengemini_tpu_torch.server.http",
    "opengemini_tpu_torch.utils.querytracker",
    "opengemini_tpu_torch.utils.governor",
]
BLOCKED_IMPORT_MODULES += FOURTEENTH_SLICE_MODULES
# the cluster's data plane: the raft meta service, users and auth, the
# router with hinted handoff, the peers' pushdown and remote scans, and
# the modules they changed
FIFTEENTH_SLICE_MODULES = [
    "opengemini_tpu_torch.utils.peers",
    "opengemini_tpu_torch.utils.tracing",
    "opengemini_tpu_torch.parallel",
    "opengemini_tpu_torch.parallel.netfault",
    "opengemini_tpu_torch.parallel.cluster",
    "opengemini_tpu_torch.meta",
    "opengemini_tpu_torch.meta.raft",
    "opengemini_tpu_torch.meta.users",
    "opengemini_tpu_torch.meta.service",
    "opengemini_tpu_torch.services.hintreplay",
    "opengemini_tpu_torch.query.partials",
    "opengemini_tpu_torch.sql.astjson",
    "opengemini_tpu_torch.query.executor",
    "opengemini_tpu_torch.query.showddl",
    "opengemini_tpu_torch.query.subquery",
    "opengemini_tpu_torch.services.continuous",
    "opengemini_tpu_torch.services.rules",
    "opengemini_tpu_torch.server.http",
]
BLOCKED_IMPORT_MODULES += FIFTEENTH_SLICE_MODULES
# the device mesh and the ts-server main, with the modules whose mesh
# paths they reach
SEVENTEENTH_SLICE_MODULES = [
    "opengemini_tpu_torch.parallel.runtime",
    "opengemini_tpu_torch.parallel.distributed",
    "opengemini_tpu_torch.server.app",
    "opengemini_tpu_torch.models.templates",
    "opengemini_tpu_torch.models.ragged",
    "opengemini_tpu_torch.models.grid",
    "opengemini_tpu_torch.ops.device_decode",
    "opengemini_tpu_torch.ops.prom",
    "opengemini_tpu_torch.promql.engine",
    "opengemini_tpu_torch.index.labels",
    "opengemini_tpu_torch.storage.colcache",
    "opengemini_tpu_torch.utils.devobs",
]
BLOCKED_IMPORT_MODULES += SEVENTEENTH_SLICE_MODULES
# the edges: log mode, the object-store tier, Arrow Flight, the tools and
# the lock-order validator
EIGHTEENTH_SLICE_MODULES = [
    "opengemini_tpu_torch.server.flight",
    "opengemini_tpu_torch.server.logstore",
    "opengemini_tpu_torch.sql.logparser",
    "opengemini_tpu_torch.storage.objstore",
    "opengemini_tpu_torch.services.obstier",
    "opengemini_tpu_torch.utils.lockdep",
    "opengemini_tpu_torch.tools",
    "opengemini_tpu_torch.tools.backup",
    "opengemini_tpu_torch.tools.export",
    "opengemini_tpu_torch.tools.mcp_server",
    "opengemini_tpu_torch.tools.monitor_agent",
]
BLOCKED_IMPORT_MODULES += EIGHTEENTH_SLICE_MODULES
# the script that times a query's request outside its stages
BLOCKED_IMPORT_MODULES += ["stage_timeline"]
# the mesh across processes: the rank worker tests/test_torch_multiproc.py
# spawns (from tests/; the port modules its main imports are above)
BLOCKED_IMPORT_MODULES += ["torch_multiproc_worker"]


@pytest.mark.parametrize("module", BLOCKED_IMPORT_MODULES)
def test_module_imports_with_jax_blocked(module):
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'opengemini_tpu'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.append({os.path.join(REPO, 'tests')!r})\n"
        f"importlib.import_module({module!r})\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
