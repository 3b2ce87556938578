"""The port's text index and match() pruning against the JAX package's,
on the CPU.

``tokenize``, ``query_grams`` and ``match_token`` on seeded ASCII, mixed
and CJK strings; the port's ``TextIndex`` (native/textindex.cpp, built
by the port) against its plain Python search and the JAX ``TextIndex``;
the ``.tidx`` sidecars a flush, a compaction and a delete rewrite write,
against the JAX package's `_TextSidecar` over the same rows; and
``match()`` in aggregate and raw selects, with the series the sidecars
pruned counted, in both packages.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from opengemini_tpu.native import textindex as jti
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage import shard as jshard
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.native import textindex as tti
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import shard as tshard
from opengemini_tpu_torch.storage.engine import Engine as TEngine

torch.set_num_threads(1)

NS = 10**9
T0 = 1_700_000_000
PACKAGES = {"jax": (JEngine, JExecutor, {}, jshard.Shard),
            "torch": (TEngine, TExecutor, {"device": "cpu"}, tshard.Shard)}
WORDS = ["error", "disk", "Full", "login", "ok", "Killed", "memory", "x",
         "42", "sshd", "日志", "错误", "启动", "café", "naïve", "数据"]


def _strings(seed, n=200):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 7))
        words = [WORDS[int(i)] for i in rng.integers(0, len(WORDS), k)]
        seps = [" ", "/", ": ", "-", "", "=", "?"]
        out.append("".join(w + seps[int(rng.integers(0, len(seps)))]
                           for w in words))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tokenize_query_grams_and_match_token_match_jax(seed):
    docs = _strings(seed)
    for d in docs:
        assert tti.tokenize(d) == jti.tokenize(d)
        assert tti.query_grams(d) == jti.query_grams(d)
    vals = np.array(docs + [None, 7], dtype=object)
    valid = np.ones(len(vals), np.bool_)
    valid[3] = False
    for term in WORDS + ["ERROR", "日", "log", "错误日志", "full disk"]:
        got = tti.match_token(vals, valid, term)
        np.testing.assert_array_equal(got, jti.match_token(vals, valid, term))


@pytest.mark.parametrize("seed", [1, 2])
def test_text_index_against_its_plain_version_and_jax(seed):
    docs = _strings(seed, 120)
    native, plain, ref = tti.TextIndex(), tti.PlainTextIndex(), \
        jti.TextIndex()
    for i, d in enumerate(docs):
        for idx in (native, plain, ref):
            idx.add(i, d)
    for term in WORDS + ["ERROR", "日", "错误日志", "nope", "full disk"]:
        want = ref.search(term).tolist()
        assert native.search(term).tolist() == want, term
        assert plain.search(term).tolist() == want, term
    assert native.token_count() == plain.token_count() == ref.token_count()
    native.close()
    ref.close()


def _lines(part, hosts=80):
    msgs = ["Out of memory: Killed process {p}", "sshd accepted {p}",
            "CRON session opened {p}", "错误 日志 {p}"]
    out = []
    for s in range(6):
        t = (T0 + part * 60 + s * 10) * NS
        for h in range(hosts):
            m = msgs[0 if h % 17 == 3 else 1 + h % 3].format(p=s % 3)
            out.append(f'syslog,host=h{h},sev={"err" if h % 2 else "info"} '
                       f'message="{m}",n={h * 10 + s}i {t}')
    return "\n".join(out)


def _build(root, pkg, flushes=2, memtable=False):
    cls, ex_cls, kw, _sh = PACKAGES[pkg]
    e = cls(str(root), **kw)
    e.create_database("db")
    for part in range(flushes):
        e.write_lines("db", _lines(part))
        e.flush_all()
    if memtable:
        e.write_lines("db", f'syslog,host=live,sev=err message="late memory '
                            f'pressure" {(T0 + 500) * NS}')
    return e, ex_cls(e)


def _jax_sidecar(root, tsf_path):
    """The JAX package's `_TextSidecar` over the rows of one TSF file,
    read back by the JAX package from `root`."""
    je = JEngine(str(root))
    [sh] = je.all_shards()
    [reader] = [r for r in sh._files if r.path == tsf_path]
    tidx = jshard._TextSidecar()
    for mst in reader.measurements():
        sids = set()
        for c in reader.chunks(mst):
            if c.packed:
                sids.update(int(s) for s in np.unique(
                    reader.read_packed_sids(c, cache=False)))
            else:
                sids.add(c.sid)
        for sid in sorted(sids):
            tidx.add(mst, sid, sh.read_series(mst, sid))
    je.close()
    return json.loads(json.dumps({
        m: {f: {t: sorted(s) for t, s in toks.items()}
            for f, toks in flds.items()} for m, flds in tidx.idx.items()}))


@pytest.mark.parametrize("step", ["flush", "compact", "delete"])
def test_sidecars_parse_equal_to_jax(tmp_path, step):
    root = tmp_path / "root"
    e, ex = _build(root, "torch")
    [sh] = e.all_shards()
    if step == "compact":
        assert sh.compact()
    elif step == "delete":
        ex.execute("DELETE FROM syslog WHERE host = 'h20'", db="db")
    paths = [r.path for r in sh._files]
    assert paths
    sidecars = {}
    for p in paths:
        with open(p[:-4] + ".tidx", encoding="utf-8") as f:
            sidecars[p] = json.load(f)
    e.close()
    for p in paths:
        assert sidecars[p] == _jax_sidecar(root, p)
        assert sidecars[p]["syslog"]["message"]["memory"]


def _count_lookups(monkeypatch, shard_cls, seen):
    orig = shard_cls.text_match_sids

    def lookup(self, mst, field, token):
        got = orig(self, mst, field, token)
        seen.append(None if got is None else len(got))
        return got

    monkeypatch.setattr(shard_cls, "text_match_sids", lookup)


SELECTS = [
    "SELECT count(message) FROM syslog WHERE match(message, 'memory') "
    "GROUP BY host",
    "SELECT host, message FROM syslog WHERE match(message, 'killed') AND "
    f"sev = 'err' AND time >= {(T0 + 10) * NS} AND time < {(T0 + 90) * NS}",
    "SELECT count(n), max(n) FROM syslog WHERE match(message, '错误')",
    "SELECT count(n) FROM syslog WHERE match(message, 'memory') OR n > 790",
    "SELECT count(message) FROM syslog WHERE match(message, 'memory') "
    f"AND time >= {T0 * NS} AND time < {(T0 + 120) * NS} GROUP BY time(1m)",
]


@pytest.mark.parametrize("memtable", [False, True])
def test_match_prunes_series_as_jax(tmp_path, monkeypatch, memtable):
    """The answers and the series each lookup left, equal in both
    packages: 'memory' and 'killed' leave 5 of 80 hosts, '错误' the hosts
    of its template; an OR prunes nothing (no lookup); GROUP BY time
    prunes nothing."""
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    got = {}
    for pkg in PACKAGES:
        seen: list = []
        _count_lookups(monkeypatch, PACKAGES[pkg][3], seen)
        e, ex = _build(tmp_path / pkg, pkg, memtable=memtable)
        answers = []
        for q in SELECTS:
            seen.clear()
            res = ex.execute(q, db="db")
            assert "error" not in res["results"][0], (q, res)
            answers.append((res, list(seen)))
        got[pkg] = answers
        e.close()
    assert got["torch"] == got["jax"]
    lookups = [s for _r, s in got["torch"]]
    assert lookups[0] == [5] and lookups[1] == [5]
    assert lookups[2] == [sum(1 for h in range(80)
                              if h % 17 != 3 and h % 3 == 2)]
    assert lookups[3] == [] and lookups[4] == []
    memory = got["torch"][0][0]["results"][0]["series"]
    assert len(memory) == 5 + memtable


def test_a_file_without_a_sidecar_prunes_nothing(tmp_path, monkeypatch):
    """A root the JAX package wrote, then a flush by the port: the JAX
    file's sidecar removed, the lookup answers None and the query answers
    the same as with the sidecars."""
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    e, ex = _build(tmp_path / "root", "jax", flushes=1)
    e.close()
    te = TEngine(str(tmp_path / "root"), device="cpu")
    te.write_lines("db", _lines(1))
    te.flush_all()
    tx = TExecutor(te)
    want = [tx.execute(q, db="db") for q in SELECTS]
    [sh] = te.all_shards()
    assert sh.text_match_sids("syslog", "message", "memory") is not None
    first = sorted(glob.glob(os.path.join(sh.path, "*.tidx")))[0]
    os.remove(first)
    sh._tidx_cache = {}
    assert sh.text_match_sids("syslog", "message", "memory") is None
    assert [tx.execute(q, db="db") for q in SELECTS] == want
    te.close()


def test_or_match_does_not_prune():
    from opengemini_tpu_torch.query import condition as cond
    from opengemini_tpu_torch.sql.parser import Parser

    stmt = Parser("SELECT v FROM m WHERE match(msg, 'a') OR v > 1"
                  ).parse_select()
    sc = cond.split(stmt.condition, set(), 0)
    assert cond.conjunctive_match_terms(sc.field_expr) == []
    stmt2 = Parser("SELECT v FROM m WHERE match(msg, 'a') AND "
                   "match(msg, 'b')").parse_select()
    sc2 = cond.split(stmt2.condition, set(), 0)
    assert cond.conjunctive_match_terms(sc2.field_expr) == [
        ("msg", "a"), ("msg", "b")]
