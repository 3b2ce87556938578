"""File quarantine of the port against the JAX package's, on the CPU.

A root with a damaged TSF file: a truncated trailer (found at open) or a
flipped bit in a data block (found by the scan that reads it). Both
packages must open the root, quarantine that one file with the same
``<file>.tsf.quar`` marker, answer the same queries over the other files,
and keep the file out across reopens by either package; a purge removes
the file, its marker and its sidecar. Also the port's counterparts of
the media-fault cases of tests/test_offlock_compact.py: a quarantined
merge input aborts the swap, and an EIO or a torn write on the merge
output aborts before it.
"""

import json
import os
import shutil
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.record import FieldType as JFieldType
from opengemini_tpu.server.http import HttpService as JHttpService
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.storage.shard import FileQuarantined as JFileQuarantined
from opengemini_tpu.storage.shard import Shard as JShard
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.record import FieldType as TFieldType
from opengemini_tpu_torch.server.http import HttpService as THttpService
from opengemini_tpu_torch.storage import diskfault
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.storage.shard import FileQuarantined
from opengemini_tpu_torch.storage.shard import Shard as TShard
from opengemini_tpu_torch.utils import failpoint
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 10**9
T0 = 1_700_000_000
HOSTS = 6
POINTS = 30  # per host and file
N_FILES = 3
QUERIES = [
    "SELECT count(v), sum(v), max(v) FROM cpu",
    "SELECT count(v), mean(v) FROM cpu GROUP BY host",
    f"SELECT max(v) FROM cpu WHERE time >= {T0 * NS} AND "
    f"time < {(T0 + N_FILES * POINTS * 10) * NS} GROUP BY time(5m)",
]
PACKAGES = {"jax": (JEngine, JExecutor, {}),
            "torch": (TEngine, TExecutor, {"device": "cpu"})}


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    yield
    failpoint.disable_all()
    diskfault.clear_all()


def _value(f, h, p):
    return float(f * 1000 + h * 100 + p) + 0.25


def _write(root, pkg):
    """N_FILES flushes of HOSTS x POINTS rows each; returns the engine."""
    cls, _ex, kw = PACKAGES[pkg]
    e = cls(str(root), **kw)
    e.create_database("db")
    for f in range(N_FILES):
        e.write_lines("db", "\n".join(
            f"cpu,host=h{h} v={_value(f, h, p)!r} "
            f"{(T0 + (f * POINTS + p) * 10) * NS}"
            for h in range(HOSTS) for p in range(POINTS)))
        e.flush_all()
    return e


def _answers(ex):
    return [ex.execute(q, db="db") for q in QUERIES]


def _oracle(files):
    """count, sum and max of v over the rows of `files` (flush indexes)."""
    vals = [_value(f, h, p) for f in files for h in range(HOSTS)
            for p in range(POINTS)]
    return len(vals), sum(vals), max(vals)


def _tsf_files(e):
    [sh] = e.all_shards()
    return sorted(os.path.join(sh.path, n) for n in os.listdir(sh.path)
                  if n.endswith(".tsf"))


def _check_total(res, files):
    count, total, vmax = _oracle(files)
    [row] = res["results"][0]["series"][0]["values"]
    assert row[1] == count and row[3] == vmax
    assert abs(row[2] - total) <= 1e-9 * abs(total)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("first", ["jax", "torch"])
def test_a_damaged_trailer_quarantines_at_open(tmp_path, writer, first):
    """One of three files loses its trailer: Engine(root) opens in both
    packages, quarantines that file with the reference's marker and
    answers over the other two; the other package then reopens the root
    and answers the same."""
    e = _write(tmp_path / "root", writer)
    e.close()
    path = _tsf_files_of(tmp_path / "root")[1]
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 10)
    answers = []
    for pkg in (first, "torch" if first == "jax" else "jax"):
        cls, ex_cls, kw = PACKAGES[pkg]
        e = cls(str(tmp_path / "root"), **kw)
        [sh] = e.all_shards()
        assert list(sh.quarantined()) == [path]
        assert sh.file_count() == N_FILES - 1
        answers.append(_answers(ex_cls(e)))
        _check_total(answers[-1][0], (0, 2))
        e.close()
        with open(path + ".quar", encoding="utf-8") as f:
            marker = json.load(f)
        assert "end magic" in marker["why"] or "too small" in marker["why"]
    assert answers[0] == answers[1]


def _tsf_files_of(root):
    out = []
    for d, _dirs, names in os.walk(root):
        out += [os.path.join(d, n) for n in names if n.endswith(".tsf")]
    return sorted(out)


def _flip_block_byte(path):
    """Flip one byte inside the first data block (right after the
    8-byte magic): a block CRC mismatch on the first read of it."""
    with open(path, "r+b") as f:
        f.seek(12)
        b = f.read(1)
        f.seek(12)
        f.write(bytes([b[0] ^ 0x40]))


def _raw(port, method, path, params):
    url = f"http://127.0.0.1:{port}{path}?{urllib.parse.urlencode(params)}"
    req = urllib.request.Request(url, data=b"" if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def test_mid_scan_quarantine_answers_as_jax_over_http(tmp_path):
    """A flipped bit in a data block of one file: the query that reads
    it fails with the reference's answer (the statement error naming the
    quarantined file), the marker is written, /debug/vars counts and
    lists the file, and the retry answers from the other files; then
    both packages reopen the root with the file still out, and the purge
    removes the file, its marker and its sidecar."""
    e = _write(tmp_path / "jax", "torch")
    e.close()
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    je = JEngine(str(tmp_path / "jax"))
    te = TEngine(str(tmp_path / "torch"), device="cpu")
    js, ts = JHttpService(je, "127.0.0.1", 0), THttpService(te, port=0)
    js.start()
    ts.start()
    try:
        victims = {}
        for name, e in (("jax", je), ("torch", te)):
            victims[name] = _tsf_files(e)[1]
            _flip_block_byte(victims[name])
        q = {"db": "db", "q": QUERIES[0]}
        got = _raw(ts.port, "GET", "/query", q)
        want = _raw(js.port, "GET", "/query", q)
        assert got[0] == want[0]
        norm = json.dumps(got[2]).replace(str(tmp_path / "torch"), "R")
        assert norm == json.dumps(want[2]).replace(str(tmp_path / "jax"),
                                                   "R")
        err = got[2]["results"][0]["error"]
        assert err.startswith("file quarantined after media fault: ")
        assert victims["torch"] in err and "crc mismatch" in err
        for name in ("jax", "torch"):
            assert os.path.exists(victims[name] + ".quar")
        status, _h, doc = _raw(ts.port, "GET", "/debug/vars", {})
        assert status == 200
        assert doc["quarantine"]["files_current"] >= 1
        assert doc["quarantine"]["tsf_files_total"] >= 1
        listed = [f for f in doc["quarantined_files"]
                  if f["path"] == victims["torch"]]
        assert listed and "crc mismatch" in listed[0]["why"]
        # the retry answers from the other two files, as JAX does
        got = _raw(ts.port, "GET", "/query", q)
        assert got[2] == _raw(js.port, "GET", "/query", q)[2]
        _check_total(got[2], (0, 2))
    finally:
        js.stop()
        ts.stop()
        je.close()
        te.close()
    # sticky across a reopen, in both packages
    answers = []
    for pkg in ("torch", "jax"):
        cls, ex_cls, kw = PACKAGES[pkg]
        e = cls(str(tmp_path / "torch"), **kw)
        assert e.quarantine_snapshot()["total"] == 1
        answers.append(_answers(ex_cls(e)))
        e.close()
    assert answers[0] == answers[1]
    # the purge: the file, its marker and its sidecar go
    te = TEngine(str(tmp_path / "torch"), device="cpu")
    victim = victims["torch"]
    assert os.path.exists(victim[:-4] + ".tidx")
    assert te.purge_quarantined() == 1
    assert te.quarantine_snapshot()["total"] == 0
    for p in (victim, victim + ".quar", victim[:-4] + ".tidx"):
        assert not os.path.exists(p)
    assert _answers(TExecutor(te)) == answers[0]
    te.close()
    je = JEngine(str(tmp_path / "torch"))
    assert _answers(JExecutor(je)) == answers[0]
    je.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_damaged_merge_input_is_quarantined_and_the_next_merge_runs(
        tmp_path, pkg):
    """A compaction that reads a damaged input quarantines it and fails;
    the next compaction merges the rest, in both packages alike."""
    e = _write(tmp_path / "root", pkg)
    [sh] = e.all_shards()
    victim = _tsf_files(e)[0]
    _flip_block_byte(victim)
    exc = JFileQuarantined if pkg == "jax" else FileQuarantined
    with pytest.raises(exc):
        sh.compact()
    assert list(sh.quarantined()) == [victim]
    assert sh.compact()
    assert sh.file_count() == 1
    _check_total(_answers(PACKAGES[pkg][1](e))[0], (1, 2))
    e.close()


# -- the media-fault cases of tests/test_offlock_compact.py ----------------

BASE = 1_700_000_000 * NS


def _pt(t, v):
    return ("m", (("host", "a"),), t, {"v": (TFieldType.FLOAT, v)})


def _mk_shard(path, n_files=3, rows_per=4):
    sh = TShard(str(path), BASE - NS, BASE + 10_000_000 * NS)
    for f in range(n_files):
        sh.write_points_structured(
            [_pt(BASE + (f * rows_per + k) * NS, float(f * rows_per + k))
             for k in range(rows_per)])
        sh.flush()
    return sh


def _series(sh):
    sid = sh.index.get_or_create("m", (("host", "a"),))
    rec = sh.read_series("m", sid)
    return {int((t - BASE) // NS): float(v)
            for t, v in zip(rec.times, rec.columns["v"].values)}


def _compact_stat(name):
    return TSTATS.counters("compact").get(name, 0)


def test_quarantined_input_aborts_the_swap(tmp_path):
    """An input pulled from the read set mid-merge fails the identity
    revalidation: the merge output is discarded (publishing it could
    resurrect dropped rows), and the next compaction merges the rest."""
    import threading

    sh = _mk_shard(tmp_path / "s")
    aborts0 = _compact_stat("swap_aborts")
    failpoint.enable("compact-before-replace", "wait:swap#1")
    out = {}
    th = threading.Thread(target=lambda: out.update(ok=sh.compact()))
    th.start()
    for _ in range(5000):
        if failpoint.hits("compact-before-replace"):
            break
        threading.Event().wait(0.001)
    victim = sh._files[0].path
    assert sh.quarantine_file(victim, "test: injected")
    failpoint.set_event("swap")
    th.join(30)
    assert not th.is_alive() and out.get("ok") is False
    assert _compact_stat("swap_aborts") == aborts0 + 1
    assert not [f for f in os.listdir(sh.path) if f.endswith(".merge")]
    assert _series(sh) == {i: float(i) for i in range(4, 12)}
    failpoint.disable_all()
    assert sh.compact()
    assert _series(sh) == {i: float(i) for i in range(4, 12)}
    sh.close()


def test_eio_on_merge_output_aborts_with_inputs_intact(tmp_path):
    """EIO while writing the merge output: the compaction fails loudly,
    nothing is published, every input file and row survives."""
    sh = _mk_shard(tmp_path / "s")
    diskfault.set_rule("*.merge*", "eio")
    with pytest.raises(OSError):
        sh.compact()
    diskfault.clear_all()
    assert sh.file_count() == 3
    assert not [f for f in os.listdir(sh.path) if f.endswith(".merge")]
    assert _series(sh) == {i: float(i) for i in range(12)}
    assert sh.compact()
    assert sh.file_count() == 1
    assert _series(sh) == {i: float(i) for i in range(12)}
    sh.close()


def test_torn_write_on_merge_output_aborts_before_the_swap(tmp_path):
    """A torn write on the output is caught by the pre-swap check of
    every block's CRC: the damaged output never replaces an input."""
    sh = _mk_shard(tmp_path / "s")
    aborts0 = _compact_stat("output_verify_aborts")
    diskfault.set_rule("*.merge*", "torn-write#1")
    assert sh.compact() is False  # aborted, no exception
    diskfault.clear_all()
    assert _compact_stat("output_verify_aborts") == aborts0 + 1
    assert sh.file_count() == 3
    assert not [f for f in os.listdir(sh.path) if f.endswith(".merge")]
    assert _series(sh) == {i: float(i) for i in range(12)}
    assert sh.compact()
    assert _series(sh) == {i: float(i) for i in range(12)}
    sh.close()


def test_jax_shard_reads_a_marker_the_port_wrote(tmp_path):
    """The port's runtime quarantine marker keeps the file out when the
    JAX package opens the shard, with the same reason."""
    sh = _mk_shard(tmp_path / "s")
    victim = sh._files[1].path
    assert sh.quarantine_file(victim, "test: injected")
    assert not sh.quarantine_file(victim, "test: again")
    sh.close()
    jsh = JShard(str(tmp_path / "s"), BASE - NS, BASE + 10_000_000 * NS)
    assert jsh.quarantined() == {victim: "test: injected"}
    sid = jsh.index.get_or_create("m", (("host", "a"),))
    got = jsh.read_series("m", sid)
    assert sorted(int((t - BASE) // NS) for t in got.times) == [
        0, 1, 2, 3, 8, 9, 10, 11]
    assert JFieldType.FLOAT == got.columns["v"].ftype
    jsh.close()
