"""The contracts of tests/test_failpoint.py and tests/test_diskfault.py,
held on the port's modules (utils/failpoint.py, storage/diskfault.py and
their sites in the WAL, memtable, TSF files, shard and engine), on the
CPU.

Each storage case runs on both packages' shards (``pkg``) with the same
arming, and the two must end alike: a flush failing at
``shard-flush-before-publish`` loses no acknowledged write after a
reopen, a crash between publish and the WAL truncate replays
idempotently, a compaction failing before its swap leaves the files
intact, a flipped bit is found before any wrong value is served, a torn
or EIO write fails where the reference fails. With no rule armed every
hook passes the IO through bit for bit.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from opengemini_tpu.record import FieldType as JFieldType
from opengemini_tpu.storage import diskfault as jdiskfault
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.storage.shard import FileQuarantined as JFileQuarantined
from opengemini_tpu.storage.shard import Shard as JShard
from opengemini_tpu.utils import failpoint as jfailpoint
from opengemini_tpu_torch.record import Column, FieldType
from opengemini_tpu_torch.storage import chunkmeta, diskfault, encoding
from opengemini_tpu_torch.storage import encodepool
from opengemini_tpu_torch.storage.engine import Engine
from opengemini_tpu_torch.storage.memtable import MemTable
from opengemini_tpu_torch.storage.shard import FileQuarantined, Shard
from opengemini_tpu_torch.storage.tsf import MAGIC, PreAgg, TSFReader
from opengemini_tpu_torch.storage.wal import _HEADER, WAL, WALCorruption
from opengemini_tpu_torch.utils import failpoint
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

NS = 1_000_000_000
BASE = 1_700_000_000 * NS
PKGS = {
    "jax": (JShard, JFieldType, jfailpoint, jdiskfault, JEngine,
            JFileQuarantined, {}),
    "torch": (Shard, FieldType, failpoint, diskfault, Engine,
              FileQuarantined, {"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    diskfault.clear_all()
    yield
    for pkg in PKGS.values():
        pkg[2].disable_all()
        pkg[3].clear_all()


@pytest.fixture
def port_encode_pool(monkeypatch):
    """The port's encode pool forced live with 4 workers."""
    prev = encodepool._pool
    monkeypatch.setattr(encodepool, "WORKERS", 4)
    monkeypatch.setattr(encodepool, "_pool", None)
    yield
    forced = encodepool._pool
    monkeypatch.setattr(encodepool, "_pool", None)
    if forced is not None and forced is not prev:
        forced.shutdown(wait=False)


def _pt(ftype, t, v):
    return ("m", (("host", "a"),), t, {"v": (ftype.FLOAT, v)})


def _shard(pkg, path, span=1000, **kw):
    return PKGS[pkg][0](str(path), BASE - NS, BASE + span * NS, **kw)


def _values(sh):
    sid = sh.index.get_or_create("m", (("host", "a"),))
    rec = sh.read_series("m", sid)
    return {int((t - BASE) // NS): float(v)
            for t, v in zip(rec.times, rec.columns["v"].values)} \
        if len(rec) else {}


# -- failpoint sites on the storage path (both packages) ------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_flush_failure_keeps_wal_and_recovers(tmp_path, pkg):
    _s, ft, fp, *_ = PKGS[pkg]
    sh = _shard(pkg, tmp_path / "s")
    sh.write_points_structured([_pt(ft, BASE, 1.0), _pt(ft, BASE + NS, 2.0)])
    fp.enable("shard-flush-before-publish", "error")
    with pytest.raises(fp.FailpointError):
        sh.flush()
    assert fp.hits("shard-flush-before-publish") == 1
    sh.close()
    fp.disable_all()
    sh2 = _shard(pkg, tmp_path / "s")  # crash-equivalent reopen
    assert _values(sh2) == {0: 1.0, 1: 2.0}
    assert sh2.file_count() == 0  # no half-written file survived
    sh2.close()


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_an_interrupted_flush_loses_no_ack_in_either_package(tmp_path,
                                                             writer):
    """A flush failing at shard-flush-before-publish: whichever package
    wrote the root, both reopen it with every acknowledged row."""
    _s, ft, fp, *_ = PKGS[writer]
    sh = _shard(writer, tmp_path / "s")
    sh.write_points_structured([_pt(ft, BASE + i * NS, float(i))
                                for i in range(20)])
    sh.flush()
    sh.write_points_structured([_pt(ft, BASE + i * NS, float(i) + 0.5)
                                for i in range(10, 30)])
    fp.enable("shard-flush-before-publish", "error")
    with pytest.raises(fp.FailpointError):
        sh.flush()
    sh.close()
    fp.disable_all()
    want = {i: float(i) for i in range(10)}
    want.update({i: float(i) + 0.5 for i in range(10, 30)})
    for reader in sorted(PKGS):
        sh2 = _shard(reader, tmp_path / "s")
        assert _values(sh2) == want, reader
        sh2.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_crash_between_publish_and_wal_truncate_is_idempotent(tmp_path, pkg):
    _s, ft, fp, *_ = PKGS[pkg]
    sh = _shard(pkg, tmp_path / "s")
    sh.write_points_structured([_pt(ft, BASE, 1.0)])
    fp.enable("shard-flush-before-wal-truncate", "error")
    with pytest.raises(fp.FailpointError):
        sh.flush()
    sh.close()
    fp.disable_all()
    sh2 = _shard(pkg, tmp_path / "s")
    assert sh2.file_count() == 1
    assert _values(sh2) == {0: 1.0}  # replayed rows dedup against the file
    sh2.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_compaction_failure_leaves_files_intact(tmp_path, pkg):
    _s, ft, fp, *_ = PKGS[pkg]
    sh = _shard(pkg, tmp_path / "s")
    for i in range(2):
        sh.write_points_structured([_pt(ft, BASE + i * NS, float(i))])
        sh.flush()
    fp.enable("compact-before-replace", "error")
    with pytest.raises(fp.FailpointError):
        sh.compact()
    fp.disable_all()
    assert _values(sh) == {0: 0.0, 1: 1.0}
    assert sh.compact()
    assert _values(sh) == {0: 0.0, 1: 1.0}
    sh.close()


def test_sleep_and_callable_actions(tmp_path):
    calls = []
    failpoint.enable("wal-before-sync", lambda: calls.append(1))
    sh = _shard("torch", tmp_path / "s", sync_wal=True)
    sh.write_points_structured([_pt(FieldType, BASE, 1.0)])
    assert calls
    failpoint.enable("wal-before-sync", "sleep:0.01")
    t0 = time.perf_counter()
    sh.write_points_structured([_pt(FieldType, BASE + NS, 2.0)])
    assert time.perf_counter() - t0 >= 0.01
    sh.close()


# -- the failpoint module itself -------------------------------------------


def test_nth_hit_gating():
    failpoint.enable("gated-site", "error#3")
    failpoint.inject("gated-site")
    failpoint.inject("gated-site")
    with pytest.raises(failpoint.FailpointError):
        failpoint.inject("gated-site")
    failpoint.inject("gated-site")  # past the nth: counts only
    assert failpoint.hits("gated-site") == 4


def test_wait_set_forces_an_ordering():
    failpoint.enable("site-a", "wait:ev1")
    failpoint.enable("site-b", "set:ev1")
    order = []

    def blocked():
        failpoint.inject("site-a")
        order.append("a-done")

    t = threading.Thread(target=blocked)
    t.start()
    for _ in range(1000):
        if failpoint.hits("site-a"):
            break
        time.sleep(0.001)
    assert not order
    failpoint.inject("site-b")  # releases ev1
    t.join(10)
    assert not t.is_alive() and order == ["a-done"]
    assert [site for _seq, site, _thr in failpoint.hit_log()] == [
        "site-a", "site-b"]


def test_wait_timeout_raises_instead_of_hanging(monkeypatch):
    monkeypatch.setattr(failpoint, "WAIT_TIMEOUT_S", 0.05)
    failpoint.enable("stuck-site", "wait:never-set")
    with pytest.raises(RuntimeError, match="timed out"):
        failpoint.inject("stuck-site")


def test_barrier_rendezvous():
    failpoint.enable("rendezvous", "barrier:3")
    released = []

    def arrive(i):
        failpoint.inject("rendezvous")
        released.append(i)

    threads = [threading.Thread(target=arrive, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    assert not released  # 2 of 3 arrived: both still parked
    t3 = threading.Thread(target=arrive, args=(2,))
    t3.start()
    for t in threads + [t3]:
        t.join(10)
        assert not t.is_alive()
    assert sorted(released) == [0, 1, 2]


def test_env_arming_and_unknown_actions(monkeypatch):
    monkeypatch.setenv("OGTPU_FAILPOINTS",
                       "wal-before-sync=error; bad ;flush=sleep:0.5")
    failpoint._load_env()
    assert failpoint.active() == {"wal-before-sync": "error",
                                  "flush": "sleep:0.5"}
    failpoint.disable_all()
    failpoint.enable("odd", "nonsense")
    with pytest.raises(ValueError, match="unknown failpoint action"):
        failpoint.inject("odd")


def test_record_all_hit_ordering_log(tmp_path):
    """record_all logs every site reached, so the flush chain's sites
    appear in causal order."""
    failpoint.record_all(True)
    sh = _shard("torch", tmp_path / "s")
    sh.write_points_structured([_pt(FieldType, BASE, 1.0)])
    sh.flush()
    sh.close()
    sites = [site for _seq, site, _thr in failpoint.hit_log()]
    chain = ["memtable-freeze", "shard-flush-after-rotate",
             "shard-flush-before-encode", "shard-flush-before-publish",
             "shard-flush-after-publish", "shard-flush-before-wal-truncate",
             "shard-flush-after-wal-truncate"]
    for a, b in zip(chain, chain[1:]):
        assert a in sites and b in sites, (a, b, sites)
        assert sites.index(a) < sites.index(b), (a, b, sites)
    assert sites.index("wal-after-append") < sites.index("memtable-freeze")
    assert "wal-rotate-before-rename" in sites


def test_stale_consolidation_store_cannot_hide_a_slab():
    """A stale consolidation stored after a newer slab arrived is never
    served: the slab-count guard recomputes it."""
    m = MemTable()

    def slab(lo, hi):
        n = hi - lo
        m.write_columnar(
            "m", np.full(n, 7, np.int64),
            np.arange(lo, hi, dtype=np.int64) * NS + BASE,
            {"v": (FieldType.FLOAT, np.arange(lo, hi, dtype=np.float64),
                   np.ones(n, np.bool_))})

    slab(0, 50)
    stale = m._consolidate("m")
    slab(50, 100)
    m._consolidated["m"] = (1, stale)  # the reader's late stale store
    m.freeze()
    [(_mst, _sids, rec)] = list(m.measurement_tables())
    assert list(rec.times) == [i * NS + BASE for i in range(100)]


def test_lost_ack_consolidation_interleaving_replay(tmp_path):
    """The lost-ack interleaving replayed at the
    memtable-consolidate-before-store site: a reader parks between its
    consolidation and the store, a writer lands a slab, the reader
    stores its stale result; the flush must still publish every row."""
    eng = Engine(str(tmp_path / "d"), device="cpu")
    eng.create_database("db")
    t0 = BASE // NS
    eng.write_lines("db", "\n".join(
        f"m,w=w0 v={i}i {(t0 + i) * NS}" for i in range(50)))
    [sh] = eng.all_shards()
    sid = sh.index.get_or_create("m", (("w", "w0"),))
    failpoint.enable("memtable-consolidate-before-store", "wait:stale#1")
    done = threading.Event()
    t = threading.Thread(target=lambda: (sh.mem.record_for(sid),
                                         done.set()), daemon=True)
    t.start()
    for _ in range(1000):
        if failpoint.hits("memtable-consolidate-before-store"):
            break
        time.sleep(0.001)
    assert failpoint.hits("memtable-consolidate-before-store") == 1
    eng.write_lines("db", "\n".join(
        f"m,w=w0 v={i}i {(t0 + i) * NS}" for i in range(50, 100)))
    failpoint.set_event("stale")
    assert done.wait(10)
    eng.flush_all()
    rec = sh.read_series("m", sid)
    assert list(rec.columns["v"].values) == list(range(100))
    eng.close()


def _run_concurrent_flush_kill(tmp_path, fp_name):
    """Concurrent writers and a flush killed at `fp_name`: (acked rows,
    the reopened shard)."""
    sh = _shard("torch", tmp_path / "s", span=10_000_000)
    sh.write_points_structured(
        [_pt(FieldType, BASE + i * NS, float(i)) for i in range(512)])
    acked = {i: float(i) for i in range(512)}
    lock = threading.Lock()
    stop = threading.Event()

    def writer(k):
        i = 0
        while not stop.is_set() and i < 300:
            t_idx = 100_000 + k * 10_000 + i
            sh.write_points_structured(
                [_pt(FieldType, BASE + t_idx * NS, float(t_idx))])
            with lock:
                acked[t_idx] = float(t_idx)  # recorded after the ack
            i += 1

    failpoint.enable(fp_name, "error")
    threads = [threading.Thread(target=writer, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    try:
        with pytest.raises(failpoint.FailpointError):
            sh.flush()
    finally:
        stop.set()
        for t in threads:
            t.join()
        failpoint.disable_all()
    sh.close()  # crash-equivalent: memtable and frozen snapshot dropped
    return acked, _shard("torch", tmp_path / "s", span=10_000_000)


@pytest.mark.parametrize("site,files", [
    ("shard-flush-before-publish", 0),
    ("shard-flush-before-wal-truncate", 1)])
def test_pooled_flush_kill_recovers_all_acked(tmp_path, port_encode_pool,
                                              site, files):
    acked, sh2 = _run_concurrent_flush_kill(tmp_path, site)
    assert sh2.file_count() == files
    assert not any(f.endswith(".tmp") for f in os.listdir(sh2.path))
    assert _values(sh2) == acked
    sh2.flush()
    assert not [f for f in os.listdir(sh2.path) if f.startswith("wal.log.")]
    assert _values(sh2) == acked
    sh2.close()


def test_flush_failure_keeps_frozen_snapshot_readable(tmp_path,
                                                      port_encode_pool):
    sh = _shard("torch", tmp_path / "s")
    sh.write_points_structured([_pt(FieldType, BASE + i * NS, float(i))
                                for i in range(64)])
    failpoint.enable("shard-flush-before-publish", "error")
    with pytest.raises(failpoint.FailpointError):
        sh.flush()
    failpoint.disable_all()
    assert len(_values(sh)) == 64  # served from the snapshot
    sh.write_points_structured([_pt(FieldType, BASE + 500 * NS, 5.0)])
    assert len(_values(sh)) == 65
    sh.flush()  # drains the queued snapshot and the new rows
    assert sh.file_count() == 2  # one file per frozen snapshot
    assert len(_values(sh)) == 65
    sh.close()


def test_engine_write_path_sites(tmp_path):
    eng = Engine(str(tmp_path / "d"), device="cpu")
    eng.create_database("db")
    failpoint.enable("engine-before-wal-commit", "error")
    with pytest.raises(failpoint.FailpointError):
        eng.write_lines("db", f"m v=1 {BASE}")
    failpoint.disable_all()
    failpoint.enable("engine-before-threshold-flush", "off")
    assert eng.write_lines("db", f"m v=2 {BASE + NS}") == 1
    assert failpoint.hits("engine-before-threshold-flush") == 1
    eng.close()
    eng2 = Engine(str(tmp_path / "d"), device="cpu")
    [sh] = eng2.all_shards()
    rec = sh.read_series("m", sh.index.get_or_create("m", ()))
    assert rec.columns["v"].values.tolist() == [1.0, 2.0]  # both applied
    eng2.close()


# -- disk-fault rules --------------------------------------------------------


def test_validate_rejects_garbage():
    for bad in ("nope", "bitflip:x", "short-read:-1", "eio#0",
                "torn-write:abc"):
        with pytest.raises(ValueError):
            diskfault.validate(bad)
    for ok in ("eio", "eio#3", "bitflip", "bitflip:7", "short-read",
               "short-read:16", "torn-write", "torn-write:4", "fsync-fail"):
        diskfault.validate(ok)


def test_pass_through_unarmed():
    buf = b"hello world"
    assert diskfault.on_read("/x/y.tsf", buf, site="tsf-block-read") is buf
    assert diskfault.on_write("/x/y.tsf", buf, site="tsf-block-write") is buf
    diskfault.on_fsync("/x/y.tsf", site="tsf-fsync")
    assert not diskfault.armed()


def test_pass_through_is_bit_identical_io(tmp_path):
    """With no rule armed the files and the WAL the port writes are the
    bytes it wrote before the hooks (the JAX package's, whose writes are
    byte-identical), and a rule on another path changes none of them."""
    out = {}
    for name, arm in (("plain", None), ("other", "*/elsewhere/*")):
        if arm:
            diskfault.set_rule(arm, "bitflip:0")
        eng = Engine(str(tmp_path / name), device="cpu")
        eng.create_database("db")
        eng.write_lines("db", "\n".join(
            f"m,w=w{i % 3} v={i}i {(BASE // NS + i) * NS}"
            for i in range(90)), now_ns=0)
        eng.flush_all()
        eng.write_lines("db", f"m,w=w0 v=7i {BASE + 500 * NS}", now_ns=0)
        eng.close()
        diskfault.clear_all()
        files = {}
        for d, _dirs, names in os.walk(tmp_path / name):
            for n in names:
                if n.endswith((".tsf", "wal.log")):
                    with open(os.path.join(d, n), "rb") as f:
                        files[os.path.relpath(os.path.join(d, n),
                                              tmp_path / name)] = f.read()
        out[name] = files
    je = JEngine(str(tmp_path / "jax"))
    je.create_database("db")
    je.write_lines("db", "\n".join(
        f"m,w=w{i % 3} v={i}i {(BASE // NS + i) * NS}" for i in range(90)))
    je.flush_all()
    je.close()
    assert out["plain"] == out["other"]
    [tsf] = [k for k in out["plain"] if k.endswith(".tsf")]
    with open(tmp_path / "jax" / tsf, "rb") as f:
        assert out["plain"][tsf] == f.read()
    assert not diskfault.hits()


def test_rule_lifecycle_and_hits():
    diskfault.set_rule("*.tsf", "bitflip:0")
    assert diskfault.rules() == [{"path": "*.tsf", "action": "bitflip:0"}]
    out = diskfault.on_read("/a/b.tsf", b"\x00\x00", site="tsf-block-read")
    assert out == b"\x01\x00"
    assert diskfault.on_read("/a/b.wal", b"\x00",
                             site="wal-replay-read") == b"\x00"
    assert diskfault.hits() == {"*.tsf=bitflip:0@tsf-block-read": 1}
    assert diskfault.clear_rule("*.tsf")
    assert not diskfault.rules()


def test_nth_hit_gating_of_rules():
    diskfault.set_rule("*.log", "eio#3")
    for _ in range(2):
        diskfault.on_read("/w/x.log", b"ok", site="wal-replay-read")
    with pytest.raises(diskfault.DiskFault):
        diskfault.on_read("/w/x.log", b"ok", site="wal-replay-read")
    diskfault.on_read("/w/x.log", b"ok", site="wal-replay-read")


def test_env_arming(monkeypatch):
    monkeypatch.setattr(diskfault, "_rules", [])
    monkeypatch.setenv("OGT_DISKFAULT",
                       "*.tsf=eio; *wal.log=torn-write:3; bad=nope")
    diskfault._load_env()
    assert diskfault.rules() == [
        {"path": "*.tsf", "action": "eio"},
        {"path": "*wal.log", "action": "torn-write:3"}]
    diskfault.clear_all()


def test_short_read_and_torn_write():
    diskfault.set_rule("*short", "short-read:4")
    assert diskfault.on_read("/a/short", b"12345678",
                             site="tsf-block-read") == b"1234"
    diskfault.set_rule("*torn", "torn-write")
    assert diskfault.on_write("/a/torn", b"12345678",
                              site="tsf-block-write") == b"1234"


# -- TSF block checksums, quarantine and faulted writes (both packages) ----


def _mk_engine(pkg, tmp_path, rows=120, series=1):
    eng = PKGS[pkg][4](str(tmp_path / "d"), **PKGS[pkg][6])
    eng.create_database("db")
    eng.write_lines("db", "\n".join(
        f"m,w=w{s} v={i}i {BASE + i * NS}"
        for s in range(series) for i in range(rows)))
    eng.flush_all()
    return eng


def _flip_byte(path, at, bit=1):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ bit]))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_bitflip_in_data_block_detected_not_decoded(tmp_path, pkg):
    eng = _mk_engine(pkg, tmp_path)
    [sh] = eng.all_shards()
    r = sh._files[0]
    loc = r.data_locs()[-1]
    eng.close()
    _flip_byte(r.path, loc[0] + loc[1] // 2)
    eng2 = PKGS[pkg][4](str(tmp_path / "d"), **PKGS[pkg][6])
    [sh2] = eng2.all_shards()
    sid = sorted(sh2.index.series_ids("m"))[0]
    with pytest.raises(PKGS[pkg][5]):
        sh2.read_series("m", sid)
    assert len(sh2.read_series("m", sid)) == 0  # never a wrong value
    assert list(sh2.quarantined()) == [r.path]
    eng2.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_armed_bitflip_on_reads_quarantines(tmp_path, pkg):
    """The same through a bitflip rule on the file's reads (the chip
    smoke's lever): the disk stays intact, the read path sees damage."""
    eng = _mk_engine(pkg, tmp_path)
    [sh] = eng.all_shards()
    path = sh._files[0].path
    sid = sorted(sh.index.series_ids("m"))[0]
    PKGS[pkg][3].set_rule(path, "bitflip")
    with pytest.raises(PKGS[pkg][5]):
        sh.read_series("m", sid)
    PKGS[pkg][3].clear_all()
    assert os.path.exists(path + ".quar")
    eng.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_injected_torn_write_caught_on_read(tmp_path, pkg):
    eng = PKGS[pkg][4](str(tmp_path / "d"), **PKGS[pkg][6])
    eng.create_database("db")
    eng.write_lines("db", "\n".join(
        f"m v={i}i {BASE + i * NS}" for i in range(50)))
    PKGS[pkg][3].set_rule("*.tsf", "torn-write#1")
    try:
        eng.flush_all()
    finally:
        PKGS[pkg][3].clear_all()
    [sh] = eng.all_shards()
    assert len(sh._files) == 1  # published: the writer saw success
    with pytest.raises(PKGS[pkg][5]):
        sh.read_series("m", sorted(sh.index.series_ids("m"))[0])
    eng.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_eio_fails_flush_loudly(tmp_path, pkg):
    eng = PKGS[pkg][4](str(tmp_path / "d"), **PKGS[pkg][6])
    eng.create_database("db")
    eng.write_lines("db", f"m v=1i {BASE}")
    PKGS[pkg][3].set_rule("*.tsf", "eio")
    with pytest.raises(PKGS[pkg][3].DiskFault):
        eng.flush_all()
    PKGS[pkg][3].clear_all()
    eng.flush_all()  # the failed flush kept its frozen snapshot
    [sh] = eng.all_shards()
    assert len(sh._files) == 1
    eng.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_meta_save_fault_raises_inside_the_op(tmp_path, pkg):
    eng = PKGS[pkg][4](str(tmp_path / "d"), **PKGS[pkg][6])
    PKGS[pkg][3].set_rule("*meta.json", "eio")
    with pytest.raises(PKGS[pkg][3].DiskFault):
        eng.create_database("db")
    PKGS[pkg][3].set_rule("*meta.json", "fsync-fail")
    with pytest.raises(PKGS[pkg][3].DiskFault):
        eng.create_database("db2")
    PKGS[pkg][3].clear_all()
    eng.create_database("db3")
    eng.close()


def test_legacy_v1_file_still_reads(tmp_path):
    times = np.arange(BASE, BASE + 10 * NS, NS, dtype=np.int64)
    col = Column(FieldType.INT, np.arange(10, dtype=np.int64),
                 np.ones(10, np.bool_))
    time_buf = encoding.encode_ints(times)
    vbuf, mbuf = encoding.encode_column(col)
    path = str(tmp_path / "legacy.tsf")
    with open(path, "wb") as f:
        f.write(MAGIC)
        off = len(MAGIC)
        locs = []
        for buf in (time_buf, vbuf, mbuf):
            locs.append([off, len(buf)])
            f.write(buf)
            off += len(buf)
        meta = {"m": {"schema": {"v": int(FieldType.INT)}, "chunks": [{
            "rows": 10, "time": locs[0], "sid": 7,
            "tmin": int(times[0]), "tmax": int(times[-1]),
            "cols": {"v": {"v": locs[1], "m": locs[2],
                           "pre": PreAgg.of(col).to_json()}},
        }]}}
        meta_buf = b"BM02" + zlib.compress(chunkmeta.encode_meta(meta), 1)
        f.write(meta_buf)
        f.write(struct.Struct("<QII").pack(off, len(meta_buf),
                                           zlib.crc32(meta_buf)))
        f.write(b"OGTSFEND")
    r = TSFReader(path)
    assert not r.block_crc
    rec = r.read_chunk("m", r.chunks("m")[0])
    assert [int(v) for v in rec.columns["v"].values] == list(range(10))
    r.close()


# -- WAL damage --------------------------------------------------------------


def _wal_frames(path):
    data = open(path, "rb").read()
    out, off = [], 0
    while off + _HEADER.size <= len(data):
        length, _crc, _kind = _HEADER.unpack_from(data, off)
        out.append((off, length))
        off += _HEADER.size + length
    return out


def _mk_wal(tmp_path, n=5):
    path = str(tmp_path / "wal.log")
    w = WAL(path)
    for i in range(n):
        w.append_lines(f"m v={i}i {BASE + i * NS}", "ns", 0)
    w.flush()
    w.close()
    return path


def test_interior_flip_raises_with_salvage(tmp_path):
    path = _mk_wal(tmp_path, 5)
    off, length = _wal_frames(path)[1]
    _flip_byte(path, off + _HEADER.size + length // 2)
    got = []
    with pytest.raises(WALCorruption) as ei:
        for entry in WAL.replay(path):
            got.append(entry)
    assert len(got) == 1
    e = ei.value
    assert len(e.clean_frames) == 1 and len(e.salvaged_frames) == 3
    vals = [ent[1] for ent in e.salvaged_entries()]
    assert [b"v=2i" in v for v in vals] == [True, False, False]


def test_torn_tail_still_truncates_silently(tmp_path):
    path = _mk_wal(tmp_path, 5)
    off, _length = _wal_frames(path)[-1]
    _flip_byte(path, off + _HEADER.size + 1)
    assert len(list(WAL.replay(path))) == 4


def test_wal_replay_read_and_append_hooks(tmp_path):
    """A bitflip rule on the WAL's replay read is the interior damage of
    the case above; a torn append surfaces at replay as a torn tail."""
    path = _mk_wal(tmp_path, 5)
    off, length = _wal_frames(path)[1]
    diskfault.set_rule(path, f"bitflip:{off + _HEADER.size + length // 2}")
    with pytest.raises(WALCorruption):
        list(WAL.replay(path))
    diskfault.clear_all()
    assert len(list(WAL.replay(path))) == 5  # the disk was never touched
    w = WAL(path)
    diskfault.set_rule(path, "torn-write")
    w.append_lines(f"m v=9i {BASE + 9 * NS}", "ns", 0)
    diskfault.clear_all()
    w.flush()
    w.close()
    assert len(list(WAL.replay(path))) == 5
    hits = diskfault.hits()
    assert not hits  # clear_all resets the counters too


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_shard_salvages_suffix_and_is_idempotent(tmp_path, pkg):
    eng = PKGS[pkg][4](str(tmp_path / "d"), **PKGS[pkg][6])
    eng.create_database("db")
    for b in range(5):
        eng.write_lines("db", "\n".join(
            f"m v={b * 10 + i}i {BASE + (b * 10 + i) * NS}"
            for i in range(10)))
    eng.close()
    wal = next(os.path.join(dp, "wal.log")
               for dp, _d, fs in os.walk(str(tmp_path / "d"))
               if "wal.log" in fs)
    off, length = _wal_frames(wal)[1]
    _flip_byte(wal, off + _HEADER.size + length // 2)

    def values(e):
        [sh] = e.all_shards()
        rec = sh.read_series("m", sh.index.get_or_create("m", ()))
        return sorted(int(v) for v in rec.columns["v"].values)

    eng2 = PKGS[pkg][4](str(tmp_path / "d"), **PKGS[pkg][6])
    want = [v for v in range(50) if not 10 <= v < 20]
    assert values(eng2) == want
    assert len([f for dp, _d, fs in os.walk(str(tmp_path / "d"))
                for f in fs if ".corrupt-" in f]) == 1
    eng2.close()
    for reader in sorted(PKGS):  # the rewritten log replays clean
        eng3 = PKGS[reader][4](str(tmp_path / "d"), **PKGS[reader][6])
        assert values(eng3) == want
        eng3.close()


def test_ctrl_endpoints_and_failpoint_hits_on_debug_vars(tmp_path):
    import http.client
    import json

    from opengemini_tpu_torch.server.http import HttpService

    eng = Engine(str(tmp_path / "d"), device="cpu")
    eng.create_database("db")
    svc = HttpService(eng, port=0)
    svc.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=30)

        def post(path, body=b""):
            conn.request("POST", path, body=body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())

        body = b"x" * 4096  # an unread body must not desync keep-alive
        assert post("/debug/ctrl?mod=diskfault&path=*&action=bogus",
                    body)[0] == 400
        status, out = post(
            "/debug/ctrl?mod=diskfault&path=*.tsf&action=eio", body)
        assert status == 200
        assert out["rules"] == [{"path": "*.tsf", "action": "eio"}]
        assert post("/debug/ctrl?mod=diskfault")[1]["rules"] == out["rules"]
        assert post("/debug/ctrl?mod=diskfault&clear=1")[1]["rules"] == []
        status, out = post("/debug/ctrl?mod=failpoint&"
                           "name=engine-before-threshold-flush&"
                           "action=sleep:0")
        assert out == {"status": "ok",
                       "failpoint": "engine-before-threshold-flush",
                       "action": "sleep:0"}
        assert post("/debug/ctrl?mod=failpoint")[1]["active"] == {
            "engine-before-threshold-flush": "sleep:0"}
        conn.request("POST", "/write?db=db", body=f"m v=1 {BASE}".encode())
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 204
        conn.request("GET", "/debug/vars")
        resp = conn.getresponse()
        doc = json.loads(resp.read())
        assert doc["failpoints"]["engine-before-threshold-flush"] == 1
        assert doc["quarantined_files"] == []
        status, out = post("/debug/ctrl?mod=failpoint&"
                           "name=engine-before-threshold-flush&action=off")
        assert out["action"] == "off"
        assert post("/debug/ctrl?mod=failpoint")[1]["active"] == {}
        assert post("/debug/ctrl?mod=nope")[0] == 400
        conn.close()
    finally:
        svc.stop()
        eng.close()


def test_quarantine_counters(tmp_path):
    before = STATS.counters("quarantine").get("tsf_files_total", 0)
    eng = _mk_engine("torch", tmp_path)
    [sh] = eng.all_shards()
    path = sh._files[0].path
    assert sh.quarantine_file(path, "test")
    assert STATS.counters("quarantine")["tsf_files_total"] == before + 1
    assert STATS.snapshot()["quarantine"]["files_current"] >= 1
    assert eng.purge_quarantined() == 1
    eng.close()


# -- a write that races DROP DATABASE (ROADMAP C5) ---------------------------

C5_POINTS = 20_000


def _c5_lines():
    return "\n".join(f"m,host=h{i % 50} v={i} {BASE + i * NS}"
                     for i in range(C5_POINTS))


def _c5_wait_for(fp, site):
    deadline = time.monotonic() + 30
    while not fp.hits(site):
        assert time.monotonic() < deadline, f"{site} never reached"
        time.sleep(0.005)


def _c5_engine(pkg, tmp_path):
    eng = PKGS[pkg][4](str(tmp_path / "d"), flush_threshold_bytes=1024,
                       **PKGS[pkg][6])
    eng.create_database("db")
    return eng


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_routed_write_racing_drop_database_answers_204(tmp_path, pkg):
    """ROADMAP C5's schedule through /write: the threshold flush waits
    at engine-before-threshold-flush, DROP DATABASE removes the shard,
    then the flush goes on; the write still answers 204."""
    import urllib.request

    from opengemini_tpu.server.http import HttpService as JHttp
    from opengemini_tpu_torch.server.http import HttpService as THttp

    fp = PKGS[pkg][2]
    eng = _c5_engine(pkg, tmp_path)
    svc = {"jax": JHttp, "torch": THttp}[pkg](eng, "127.0.0.1", 0)
    svc.start()
    fp.enable("engine-before-threshold-flush", "wait:go")
    got = {}

    def post():
        req = urllib.request.Request(
            f"http://127.0.0.1:{svc.port}/write?db=db",
            data=_c5_lines().encode(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                got["status"] = r.status
        except Exception as e:  # noqa: BLE001 — the assertion shows it
            got["error"] = repr(e)

    t = threading.Thread(target=post)
    t.start()
    try:
        _c5_wait_for(fp, "engine-before-threshold-flush")
        res = svc.executor.execute("DROP DATABASE db")
        assert "error" not in res["results"][0], res
        fp.set_event("go")
        t.join(60)
        assert not t.is_alive()
        assert got == {"status": 204}
        assert "db" not in eng.databases
    finally:
        fp.set_event("go")
        svc.stop()
        eng.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_write_lines_racing_drop_database_counts_its_points(tmp_path, pkg):
    """The same schedule on the engine: write_lines returns 20000."""
    fp = PKGS[pkg][2]
    eng = _c5_engine(pkg, tmp_path)
    fp.enable("engine-before-threshold-flush", "wait:go")
    got = {}
    t = threading.Thread(
        target=lambda: got.update(n=eng.write_lines("db", _c5_lines())))
    t.start()
    try:
        _c5_wait_for(fp, "engine-before-threshold-flush")
        eng.drop_database("db")
        fp.set_event("go")
        t.join(60)
        assert got == {"n": C5_POINTS}
        assert eng.all_shards() == []
    finally:
        fp.set_event("go")
        eng.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_flush_all_racing_drop_database(tmp_path, pkg):
    """flush_all snapshots its shards, then DROP DATABASE removes one
    before its turn (the first shard's flush drops it): flush_all
    returns, and the other database's rows are flushed."""
    fp = PKGS[pkg][2]
    eng = PKGS[pkg][4](str(tmp_path / "d"), **PKGS[pkg][6])
    for db in ("a", "db"):
        eng.create_database(db)
        eng.write_lines(db, f"m v=1 {BASE}")
    fp.enable("shard-flush-before-encode",
              lambda: eng.drop_database("db"))
    try:
        eng.flush_all()
        fp.disable_all()
        assert "db" not in eng.databases
        [sh] = eng.all_shards()
        assert sh.file_count() == 1
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_live_shards_failing_flush_still_raises(tmp_path, pkg):
    """Only a dropped shard's flush failure is swallowed: a live shard's
    raises, from the threshold flush of a write and from flush_all."""
    fp = PKGS[pkg][2]
    eng = _c5_engine(pkg, tmp_path)
    fp.enable("shard-flush-before-encode", "error")
    try:
        with pytest.raises(fp.FailpointError):
            eng.write_lines("db", _c5_lines())
        with pytest.raises(fp.FailpointError):
            eng.flush_all()
        fp.disable_all()
        eng.flush_all()
        assert sum(sh.file_count() for sh in eng.all_shards()) >= 1
    finally:
        eng.close()
