"""The port's integrity scrub (services/scrub.py, /debug/ctrl?mod=scrub)
against the JAX package, on the CPU.

The cases of the reference's tests/test_diskfault.py TestScrub run in
both packages on the same writes and the same damage (a flipped byte in
a data block, or a disk-fault bitflip rule of each package's own
storage/diskfault.py): the verified bytes of every tick, the pace of a
budgeted sweep (its cursor and passes), the quarantined files and the
scrub counters' deltas are equal, and the ctrl surface answers alike.
A root with no router attached repairs nothing; with a router at rf 2
the scrub's repair pulls a quarantined file's rows back from the other
replica through the anti-entropy round, alike in both packages.
"""

from __future__ import annotations

import http.client
import json
import os

import pytest
import torch

from opengemini_tpu.parallel import cluster as jcluster
from opengemini_tpu.server import http as jhttp
from opengemini_tpu.services import scrub as jscrub
from opengemini_tpu.storage import diskfault as jdf
from opengemini_tpu.storage import engine as jeng
from opengemini_tpu.utils.stats import GLOBAL as JSTATS
from opengemini_tpu_torch.parallel import cluster as tcluster
from opengemini_tpu_torch.server import http as thttp
from opengemini_tpu_torch.services import scrub as tscrub
from opengemini_tpu_torch.storage import diskfault as tdf
from opengemini_tpu_torch.storage import engine as teng
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_000


class Pkg:
    def __init__(self, name, eng, scrub, df, stats, http, kw):
        self.name, self.eng, self.scrub, self.df = name, eng, scrub, df
        self.stats, self.http, self.kw = stats, http, kw

    def engine(self, root):
        return self.eng.Engine(str(root), **self.kw)


JAX = Pkg("jax", jeng, jscrub, jdf, JSTATS, jhttp, {})
PORT = Pkg("torch", teng, tscrub, tdf, TSTATS, thttp, {"device": "cpu"})
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean_rules():
    jdf.clear_all()
    tdf.clear_all()
    yield
    jdf.clear_all()
    tdf.clear_all()


def _mk(p, root, rows=120, series=1, files=1):
    e = p.engine(root)
    e.create_database("db")
    per = rows // files
    for f in range(files):
        e.write_lines("db", "\n".join(
            f"m,s=s{s_} v={(i * 7) % 1000}i {(BASE + i) * NS}"
            for s_ in range(series) for i in range(f * per, (f + 1) * per)))
        e.flush_all()
    return e


def _flip_byte(path, at, bit=1):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ bit]))


def _files(e) -> list:
    return [r for sh in e.all_shards() for r in sh._files]


def _rel(root, snap) -> dict:
    return {"total": snap["total"],
            "files": [(os.path.relpath(f["path"], root), f["why"])
                      for f in snap["files"]]}


def _deltas(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(before) | set(after) if after.get(k, 0)
            != before.get(k, 0)}


def both(tmp_path, scenario):
    outs = [scenario(p, tmp_path / p.name) for p in PKGS]
    assert outs[1] == outs[0]
    return outs[1]


@pytest.mark.parametrize("how", ["flipped", "bitflip-rule"])
def test_detects_and_quarantines(tmp_path, how):
    def scenario(p, root):
        e = _mk(p, root, rows=300, series=3, files=2)
        try:
            victim = _files(e)[1]
            if how == "flipped":
                _flip_byte(victim.path, victim.data_locs()[0][0] + 3)
            else:
                p.df.set_rule("*/" + os.path.basename(victim.path),
                              "bitflip:5")
            c0 = dict(p.stats.counters("scrub"))
            s = p.scrub.ScrubService(e, 3600.0, mb_per_tick=64)
            verified = s.tick_now()
            p.df.clear_all()
            snap = _rel(str(root), e.quarantine_snapshot())
            assert snap["total"] == 1
            assert snap["files"][0][0].endswith(
                os.path.basename(victim.path))
            d = _deltas(c0, p.stats.counters("scrub"))
            assert d.get("corruptions_found_total", 0) == 1
            # the next pass verifies the healthy file only
            again = s.tick_now()
            return verified, again, snap, d, s.passes
        finally:
            e.close()

    both(tmp_path, scenario)


def test_full_pass_verifies_every_block(tmp_path):
    def scenario(p, root):
        e = _mk(p, root, rows=600, series=4, files=3)
        try:
            total = sum(loc[1] for r in _files(e) for loc in r.data_locs())
            s = p.scrub.ScrubService(e, 3600.0, mb_per_tick=64)
            verified = s.tick_now()
            assert verified == total
            assert s.passes == 1 and e.quarantine_snapshot()["total"] == 0
            status = {k: v for k, v in s.status().items() if k != "counters"}
            return total, verified, status
        finally:
            e.close()

    both(tmp_path, scenario)


def test_byte_budget_paces_the_sweep(tmp_path):
    def scenario(p, root):
        e = p.engine(root)
        e.create_database("db")
        try:
            e.write_lines("db", "\n".join(
                f"m,w=w{s_} v={(i * 37) % 1009}i {(BASE + i) * NS}"
                for s_ in range(8) for i in range(4000)))
            e.flush_all()
            s = p.scrub.ScrubService(e, 3600.0)
            s.mb_per_tick = 0.001  # about 1 KB a tick: the pace shows
            total = sum(loc[1] for r in _files(e) for loc in r.data_locs())
            ticks = [s.tick_now()]
            assert 0 < ticks[0] < total
            assert s._cursor  # the mid-file resume point
            for _ in range(4096):
                if s.passes:
                    break
                ticks.append(s.tick_now())
            assert s.passes >= 1 and sum(ticks) == total
            return ticks, sorted(s._cursor.values())
        finally:
            e.close()

    both(tmp_path, scenario)


def test_disabled_by_env_is_inert(tmp_path, monkeypatch):
    monkeypatch.setenv("OGT_SCRUB", "0")

    def scenario(p, root):
        e = _mk(p, root, rows=50)
        try:
            s = p.scrub.ScrubService(e, 3600.0)
            assert not s.enabled
            return s.tick_now(), s.status()["enabled"]
        finally:
            e.close()

    assert both(tmp_path, scenario) == (0, False)


def test_tenant_charged_for_scrubbed_bytes(tmp_path):
    from opengemini_tpu.utils.governor import GOVERNOR as JGOV
    from opengemini_tpu_torch.utils.governor import GOVERNOR as TGOV

    def scenario(p, root):
        gov = JGOV if p is JAX else TGOV
        e = _mk(p, root, rows=200, series=2)
        gov.configure(budget_mb=64)
        gov.reset()
        try:
            n = p.scrub.ScrubService(e, 3600.0).tick_now()
            assert gov.tenant_accounts()["db"]["scrub_bytes"] == n
            return n
        finally:
            gov.configure(budget_mb=0)
            gov.reset()
            e.close()

    both(tmp_path, scenario)


def _ctrl(port, conn, query, body=b""):
    conn.request("POST", "/debug/ctrl?" + query, body=body)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_ctrl_endpoints(tmp_path):
    """mod=scrub's ops and knobs, its errors (a bad op, a bad or
    non-positive knob rejects the whole request), and the quarantine
    inventory after a bitflip rule armed through mod=diskfault."""
    def scenario(p, root):
        e = _mk(p, root, rows=120, series=2, files=2)
        svc = p.http.HttpService(e, "127.0.0.1", 0)
        svc.start()
        out = []
        try:
            conn = http.client.HTTPConnection("127.0.0.1", svc.port,
                                              timeout=30)
            for q in ("mod=scrub&op=bogus", "mod=scrub&mb=0",
                      "mod=scrub&mb=2&interval_s=x", "mod=scrub"):
                code, doc = _ctrl(svc.port, conn, q, b"x" * 1024)
                doc.pop("scrub", None)
                out.append((code, doc))
            code, doc = _ctrl(svc.port, conn, "mod=scrub&op=tick&mb=2")
            assert code == 200 and doc["scrub"]["mb_per_tick"] == 2
            out.append((doc["verified_bytes"], doc["quarantine"],
                        doc["scrub"]["passes"]))
            victim = os.path.basename(_files(e)[0].path)
            code, doc = _ctrl(svc.port, conn, "mod=diskfault&path=*/"
                              f"{victim}&action=bitflip:9")
            assert code == 200
            code, doc = _ctrl(svc.port, conn, "mod=scrub&op=tick")
            code2, _ = _ctrl(svc.port, conn, "mod=diskfault&clear=1")
            out.append((code, doc["verified_bytes"],
                        _rel(str(root), doc["quarantine"])))
            assert doc["quarantine"]["total"] == 1
            code, doc = _ctrl(svc.port, conn, "mod=scrub&op=purge")
            out.append((code, doc["purged_files"],
                        doc["quarantine"]["total"]))
            conn.close()
            return out
        finally:
            svc.stop()
            e.close()

    both(tmp_path, scenario)


class _Fsm:
    def __init__(self, addrs):
        self.nodes = {n: {"addr": a, "role": "data"}
                      for n, a in addrs.items()}


class _Store:
    token = ""

    def __init__(self, addrs):
        self.fsm = _Fsm(addrs)


def test_quarantined_file_repaired_from_its_replica(tmp_path):
    """Two nodes at rf 2 hold the same rows; a flipped byte in one
    node's file is quarantined by its scrub tick, whose repair round
    pulls the measurement back from the replica: the node's rows and
    digest equal the replica's again, and the scrub counters say so."""
    def scenario(p, root):
        cluster = jcluster if p is JAX else tcluster
        engines, svcs, addrs = {}, {}, {}
        for nid in ("nA", "nB"):
            e = _mk(p, root / nid, rows=300, series=3, files=2)
            svc = p.http.HttpService(e, "127.0.0.1", 0)
            svc.start()
            engines[nid], svcs[nid] = e, svc
            addrs[nid] = f"127.0.0.1:{svc.port}"
        try:
            for nid, svc in svcs.items():
                svc.router = cluster.DataRouter(
                    engines[nid], _Store(addrs), nid, addrs[nid], rf=2)
                svc.executor.router = svc.router
                svc.router.probe_health()
            eA, eB = engines["nA"], engines["nB"]
            victim = _files(eA)[1]
            _flip_byte(victim.path, victim.data_locs()[0][0] + 3)
            c0 = dict(p.stats.counters("scrub"))
            s = p.scrub.ScrubService(eA, 3600.0, router=svcs["nA"].router,
                                     mb_per_tick=64)
            s.tick_now()
            assert eA.quarantine_snapshot()["total"] == 1
            d = _deltas(c0, p.stats.counters("scrub"))
            assert d.get("repairs_triggered_total") == 1
            assert d.get("repaired_divergences_total") == 1
            [shA] = eA.all_shards()
            [shB] = eB.all_shards()
            assert shA.content_digest() == shB.content_digest()
            rows = {sid_key: shA.read_series("m", sid).times.tolist()
                    for sid_key, sid in (
                        (shA.index.series_entry(x)[1], x)
                        for x in shA.index.series_ids("m"))}
            assert sum(map(len, rows.values())) == 300 * 3
            return d, shA.content_digest(), sorted(rows.items())
        finally:
            for nid in svcs:
                svcs[nid].stop()
                engines[nid].close()

    both(tmp_path, scenario)
