"""The port's raft (meta/raft.py) and its meta store (meta/service.py)
against the JAX package, on the CPU.

Every case of the reference's tests/test_raft.py runs on the port: the
reference's own source, with ``opengemini_tpu`` read as
``opengemini_tpu_torch`` and each ``Engine(...)`` opened on the CPU
(``mirror_reference``), held to the reference test's own checks on the
in-memory bus (elections, log repair, persistence, compaction and
InstallSnapshot, replicated DDL, users and registries, membership, the
segmented log). Besides, the same seeded schedule of ticks, proposals
and partitions drives a JAX and a port cluster to the same terms,
leaders, logs and applied commands.

``mirror_reference`` is shared by the other cluster test files
(test_torch_{cluster,partials,auth,netfault,failureview,tls}.py).
"""

from __future__ import annotations

import os
import random
import re

import pytest
import torch

from opengemini_tpu.meta import raft as jraft
from opengemini_tpu_torch.meta import raft as traft
from opengemini_tpu_torch.storage.engine import Engine as _TEngine

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))


class CpuEngine(_TEngine):
    """The port's Engine, on the CPU unless told otherwise."""

    def __init__(self, root, *args, device="cpu", **kwargs):
        super().__init__(root, *args, device=device, **kwargs)


def mirror_reference(ref: str, names=None, suffix: str = "Port") -> dict:
    """The reference test module `ref` (tests/<ref>.py) run against the
    port: its source with the package renamed and every ``Engine(`` an
    engine on the CPU, executed as a module of its own. Returns the test
    classes (renamed ``<Class><suffix>``), test functions
    (``<name>_<suffix lower>``) and fixtures it defines, for the caller's
    globals; `names` keeps only those classes and functions, where
    ``"TestX.test_y"`` keeps one method of a class."""
    path = os.path.join(_HERE, f"{ref}.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    src = re.sub(r"\bopengemini_tpu\b", "opengemini_tpu_torch", src)
    src = re.sub(r"(?<![\w.])Engine\(", "_CpuEngine(", src)
    ns = {"__name__": f"{ref}_on_port", "__file__": path,
          "_CpuEngine": CpuEngine}
    exec(compile(src, f"{path} (on the port)", "exec"), ns)  # noqa: S102
    methods: dict[str, set] = {}
    for n in names or ():
        cls, _, meth = n.partition(".")
        if meth:
            methods.setdefault(cls, set()).add(meth)
    out = {}
    for name, obj in ns.items():
        if getattr(obj, "_pytestfixturefunction", None) is not None or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            out[name] = obj
        elif names is not None and name not in names and \
                name not in methods:
            continue
        elif name.startswith("Test") and isinstance(obj, type):
            # a method left out is hidden (pytest collects callables only)
            hidden = {m: None for m in dir(obj)
                      if m.startswith("test_") and name in methods
                      and m not in methods[name]}
            out[name + suffix] = type(name + suffix, (obj,), hidden)
        elif name.startswith("test_") and callable(obj):
            out[f"{name}_{suffix.lower()}"] = obj
    return out


globals().update(mirror_reference("test_raft"))


# -- the same schedule through both packages -----------------------------


class Bus:
    """A synchronous in-memory transport with partitions (as the
    reference test's)."""

    def __init__(self):
        self.nodes = {}
        self.queue = []
        self.cut = set()

    def send(self, peer, msg):
        self.queue.append((peer, msg))

    def deliver_all(self):
        for _ in range(100):
            if not self.queue:
                return
            batch, self.queue = self.queue, []
            for peer, msg in batch:
                if frozenset((peer, msg["from"])) in self.cut:
                    continue
                node = self.nodes.get(peer)
                if node is not None:
                    node.deliver(msg)
        raise AssertionError("bus did not quiesce")


def _run_schedule(mod, tmp_path, seed: int):
    """Ticks, proposals and a partition from one seed; the observable
    state after each step."""
    random.seed(seed)
    bus = Bus()
    ids = ["n0", "n1", "n2"]
    applied = {i: [] for i in ids}
    nodes = {
        i: mod.RaftNode(i, ids, bus,
                        apply_fn=lambda idx, cmd, i=i: applied[i].append(
                            (idx, cmd)),
                        storage_path=str(tmp_path / f"{i}.raftlog"))
        for i in ids
    }
    bus.nodes = nodes
    rng = random.Random(seed + 1)
    trail = []
    for step in range(400):
        for n in nodes.values():
            n.tick()
        bus.deliver_all()
        leaders = [i for i, n in nodes.items() if n.state == mod.LEADER]
        if leaders and rng.random() < 0.3:
            nodes[leaders[0]].propose({"op": "k", "v": step})
            bus.deliver_all()
        if step == 150 and leaders:
            for other in ids:
                if other != leaders[0]:
                    bus.cut.add(frozenset((leaders[0], other)))
        if step == 250:
            bus.cut = set()
        trail.append(tuple((i, n.state, n.current_term, n.commit_index)
                           for i, n in sorted(nodes.items())))
    logs = {i: [(e.term, e.cmd) for e in n.log] for i, n in nodes.items()}
    return trail, logs, applied


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_same_schedule_same_cluster(tmp_path, seed):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = _run_schedule(jraft, tmp_path / "j", seed)
    t = _run_schedule(traft, tmp_path / "t", seed)
    assert j == t
    # each package's files: the same state file and log segment bytes
    for name in sorted(os.listdir(tmp_path / "j")):
        with open(tmp_path / "j" / name, "rb") as fj, \
                open(tmp_path / "t" / name, "rb") as ft:
            assert fj.read() == ft.read(), name
