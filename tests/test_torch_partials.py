"""The port's aggregate pushdown (query/partials.py: compute_partials on
the peer's device, the wire format, merge_remote_partials) against the
JAX package, on the CPU.

Every case of the reference's tests/test_partials.py runs on the port
(test_torch_raft.mirror_reference). Besides, the same request against
the same rows gives the JAX package's partials (groups, arrays; floats
rel 1e-12) and each package parses the other's bytes, and the raw scan's
JSON and binary bodies and the metadata round are the JAX package's
byte for byte.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from opengemini_tpu.parallel import cluster as jcluster
from opengemini_tpu.query import partials as jpartials
from opengemini_tpu.query.condition import split as jsplit
from opengemini_tpu.sql import astjson as jastjson
from opengemini_tpu.sql.parser import parse as jparse
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.parallel import cluster as tcluster
from opengemini_tpu_torch.query import partials as tpartials
from test_torch_raft import CpuEngine, mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_partials"))


# -- the wire against the JAX package -------------------------------------


NS_ = 1_000_000_000
T0 = 1_700_002_800


def _pair(tmp_path, hosts=5, n=240, flush=False):
    """A JAX engine and a port engine with the same seeded rows (in
    files with `flush`)."""
    rng = np.random.default_rng(11)
    lines = []
    for h in range(hosts):
        v = np.round(rng.normal(20, 5, n), 3)
        c = rng.integers(0, 40, n)
        for i in range(n):
            lines.append(f"cpu,host=h{h},dc=d{h % 2} v={float(v[i])!r},"
                         f"c={int(c[i])}i {(T0 + i * 15) * NS_ + h}")
    text = "\n".join(lines)
    out = []
    for mk, root in ((JEngine, "j"), (CpuEngine, "t")):
        e = mk(str(tmp_path / root))
        e.create_database("db")
        e.write_lines("db", text)
        if flush:
            e.flush_all()
        out.append(e)
    return out


REQS = [
    # GROUP BY time(): the grid (kernel 3 on the card)
    ("SELECT mean(v), max(v), count(v) FROM cpu GROUP BY time(1m)",
     ["host"], {"v": ["count", "max", "mean"]}, 60),
    # by tag with selectors: the bucketed batch (kernels 1 and 2)
    ("SELECT first(v), last(v), min(v), max(v), stddev(v), spread(v) "
     "FROM cpu GROUP BY host",
     ["host"], {"v": ["first", "last", "min", "max", "stddev", "spread"]},
     0),
    # rank aggregates ship multisets; an int sum stays exact
    ("SELECT median(c), percentile(c, 90), sum(c) FROM cpu GROUP BY dc",
     ["dc"], {"c": ["median", "percentile", "sum"]}, 0),
    ("SELECT sum(v) FROM cpu WHERE dc = 'd1' AND v > 20",
     [], {"v": ["sum"]}, 0),
]


def _req(text, group_tags, aggs, every_s):
    stmt = jparse(text)[0]
    sc = jsplit(stmt.condition, {"host", "dc"}, (T0 + 86400) * NS_)
    tmin, tmax = T0 * NS_, (T0 + 3600) * NS_
    W = (tmax - tmin) // (every_s * NS_) if every_s else 1
    return {
        "db": "db", "rp": None, "mst": "cpu", "tmin": tmin, "tmax": tmax,
        "aligned": tmin, "every_ns": every_s * NS_, "offset_ns": 0,
        "W": W, "group_tags": group_tags, "aggs": aggs,
        "tag_expr": jastjson.to_json(sc.tag_expr),
        "field_expr": jastjson.to_json(sc.field_expr),
        "mixed_expr": jastjson.to_json(sc.mixed_expr),
        "mixed_series_level": False, "tag_keys": ["dc", "host"],
    }


def _same_array(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                        b.dtype)
    if a.dtype.kind == "f":
        for x, y in zip(a.tolist(), b.tolist()):
            assert (math.isnan(x) and math.isnan(y)) or math.isclose(
                x, y, rel_tol=1e-12, abs_tol=1e-12), (where, x, y)
    else:
        assert a.tolist() == b.tolist(), where


@pytest.mark.parametrize("hosts,n", [(5, 240), (70, 30)],
                         ids=["per-series", "bulk"])
@pytest.mark.parametrize("spec", REQS, ids=["grid", "selectors", "rank",
                                            "filtered"])
def test_partials_equal_to_jax(tmp_path, spec, hosts, n):
    """The same request against the same rows: the port's partials
    header, groups and arrays equal the JAX package's (floats rel
    1e-12), and each package parses the other's bytes; with 64 series
    or more a shard's rows come from one bulk read."""
    je, te = _pair(tmp_path, hosts, n)
    try:
        req = _req(*spec)
        jb = jpartials.compute_partials(je, None, dict(req))
        tb = tpartials.compute_partials(te, None, dict(req))
        j = jpartials.parse_partials(jb)
        t = tpartials.parse_partials(tb)
        assert t["groups"] == j["groups"] and t["W"] == j["W"]
        assert sorted(t["fields"]) == sorted(j["fields"])
        for f in j["fields"]:
            assert sorted(t["fields"][f]) == sorted(j["fields"][f])
            for p in j["fields"][f]:
                _same_array(t["fields"][f][p], j["fields"][f][p], (f, p))
        # cross-parse: each package reads the other's bytes as its own
        for parse, data, ref in ((jpartials.parse_partials, tb, t),
                                 (tpartials.parse_partials, jb, j)):
            got = parse(data)
            assert got["groups"] == ref["groups"]
            for f in ref["fields"]:
                for p in ref["fields"][f]:
                    _same_array(got["fields"][f][p], ref["fields"][f][p],
                                (f, p))
    finally:
        je.close()
        te.close()


@pytest.mark.parametrize("hosts,flush", [(3, False), (70, False),
                                         (70, True)],
                         ids=["per-series", "memtable", "bulk"])
def test_scan_wire_and_meta_equal_to_jax(tmp_path, hosts, flush):
    """/internal/scan's binary and JSON bodies and the select_meta doc
    are the JAX package's, byte for byte (with 64 series or more in
    files of one field set a shard's rows come from one bulk read)."""
    je, te = _pair(tmp_path, hosts=hosts, n=50, flush=flush)
    try:
        args = ("db", None, "cpu", T0 * NS_, (T0 + 600) * NS_)
        assert tcluster.serialize_series_binary(te, *args) == \
            jcluster.serialize_series_binary(je, *args)
        assert tcluster.serialize_series(te, *args) == \
            jcluster.serialize_series(je, *args)
        assert tcluster.serialize_select_meta(te, *args) == \
            jcluster.serialize_select_meta(je, *args)
        doc = tcluster.parse_series_binary(
            jcluster.serialize_series_binary(je, *args))
        ref = jcluster.parse_series_binary(
            jcluster.serialize_series_binary(je, *args))
        assert [s["tags"] for s in doc["series"]] == \
            [s["tags"] for s in ref["series"]]
        for s, r in zip(doc["series"], ref["series"]):
            assert s["times"].tolist() == r["times"].tolist()
            for name in r["fields"]:
                assert s["fields"][name]["values"].tolist() == \
                    r["fields"][name]["values"].tolist()
    finally:
        je.close()
        te.close()
