"""The port's lock-order validator (utils/lockdep.py) against the JAX
package's, on the CPU.

Every case of the reference's tests/test_lockdep.py runs on the port
(``mirror_reference``; its armed scenarios run in subprocesses with
``OGT_LOCKDEP=1``). Unarmed, the port's names are the ``threading``
classes themselves. The port builds a lockdep lock at every site where
the reference builds one (the same attribute, hot marks and class
names, file for file), and its concurrency tests (rules, rollups, a
three-node cluster) run armed in a subprocess with no violation.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import threading

import pytest

from opengemini_tpu_torch.utils import lockdep as tlockdep
from test_torch_raft import mirror_reference

globals().update(mirror_reference("test_lockdep"))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SITE = re.compile(
    r"^\s*([\w.\[\]]+)\s*=\s*(?:[\w\[\]]+\s*=\s*)?(?:\[0, )?"
    r"(lockdep\.(?:mark_hot|name_class)\(\s*)?lockdep\.(Lock|RLock|"
    r"Condition)\(([^)]*)\)(?:,\s*\"([^\"]+)\")?", re.M)


def _sites(pkg: str) -> set:
    """(module, attribute, kind, argument, class name) of every lockdep
    constructor in a package, the validator itself left out."""
    out = set()
    base = os.path.join(ROOT, pkg)
    for d, _dirs, files in os.walk(base):
        for f in files:
            if not f.endswith(".py") or f == "lockdep.py":
                continue
            path = os.path.join(d, f)
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            rel = os.path.relpath(path, base)
            for m in _SITE.finditer(src):
                wrap = (m.group(2) or "").split("(")[0]
                out.add((rel, m.group(1), wrap, m.group(3), m.group(4),
                         m.group(5)))
    return out


def test_the_port_builds_a_lockdep_lock_at_every_reference_site():
    ref = _sites("opengemini_tpu")
    port = _sites("opengemini_tpu_torch")
    assert len(ref) >= 50
    assert ref - port == set()


def test_allow_blocking_sits_at_the_reference_reasons():
    def reasons(pkg):
        out = []
        for d, _dirs, files in os.walk(os.path.join(ROOT, pkg)):
            for f in files:
                if f.endswith(".py") and f != "lockdep.py":
                    with open(os.path.join(d, f), encoding="utf-8") as fh:
                        out += re.findall(
                            r'allow_blocking\(\s*"([^"]+)"', fh.read())
        return sorted(out)

    assert reasons("opengemini_tpu_torch") == reasons("opengemini_tpu")


def test_unarmed_names_are_the_threading_classes():
    if tlockdep.enabled():
        pytest.skip("this session runs armed (OGT_LOCKDEP=1)")
    assert tlockdep.Lock is threading.Lock
    assert tlockdep.RLock is threading.RLock
    assert tlockdep.Condition is threading.Condition
    lk = tlockdep.RLock()
    assert tlockdep.mark_hot(lk, "x") is lk
    assert tlockdep.name_class(lk, "y") is lk
    with tlockdep.allow_blocking("anything"):
        pass


ARMED = """
import sys, pytest
from opengemini_tpu_torch.utils import lockdep
assert lockdep.enabled()
rc = pytest.main([
    "tests/test_torch_rollup.py", "tests/test_torch_rules.py",
    "tests/test_torch_cluster.py::test_three_nodes_answer_as_one_engine",
    "-q", "-p", "no:xdist", "-p", "no:cacheprovider", "-p", "no:randomly",
    "-k", "not jax"])
v = lockdep.violations()
print("LOCKDEP", rc, len(v), lockdep.stats_snapshot())
for x in v:
    print(x)
sys.exit(1 if (rc or v) else 0)
"""


def test_the_port_concurrency_tests_run_armed_without_a_violation():
    env = dict(os.environ, OGT_LOCKDEP="1", JAX_PLATFORMS="cpu")
    env.pop("OGT_LOCKDEP_HOLD_MS", None)
    proc = subprocess.run([sys.executable, "-c", ARMED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("LOCKDEP")][-1]
    assert line.startswith("LOCKDEP 0 0 "), line
    assert "'classes': 0" not in line  # the port's locks were tracked
