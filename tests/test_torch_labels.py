"""The port's columnar label tier (index/labels.py) against the JAX
package's tier and against the set walk of the index, on the same
series: =, !=, =~ and !~ with missing tags, the empty value and
empty-matching regexes; staleness after inserts and removals through
the mergeset index; the LUT gather's device route on CPU tensors
(OGT_LABEL_INDEX_DEVICE=1 above the row threshold); the label-tier
branches of query/condition.py; and the PromQL matcher composition
(_match_sids). Answers must be equal, sid for sid."""

import random
import tempfile

import numpy as np
import pytest

from opengemini_tpu.index import labels as jlabels
from opengemini_tpu.index.inverted import SeriesIndex as JSeriesIndex
from opengemini_tpu.query import condition as jcond
from opengemini_tpu.query import offload as joffload
from opengemini_tpu.sql.parser import parse as jparse
from opengemini_tpu_torch.index import labels as tlabels
from opengemini_tpu_torch.index import mergeset as tmsi
from opengemini_tpu_torch.index.inverted import SeriesIndex as TSeriesIndex
from opengemini_tpu_torch.query import condition as tcond
from opengemini_tpu_torch.query import offload as toffload
from opengemini_tpu_torch.sql.parser import parse as tparse
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

VALUES = ["", "a", "api-1", "api-2", "api-10", "web", "eu", "eu-west",
          "us", "x,y", "spa ce"]
KEYS = ("job", "region", "pod", "rare")
PATTERNS = [r"api-.*", r".*", r"", r"a|eu", r"^$", r"(api)?.*1",
            r"eu.*|us", r"nomatch\d+", r"(?:)", r"[aw]"]


def _rand_series(rng, n):
    out = []
    for _ in range(n):
        tags = sorted({(k, rng.choice(VALUES))
                       for k in KEYS if rng.random() < 0.7})
        out.append(tuple(tags))
    return out


def _pair(series):
    """The same series in both packages' in-memory indexes."""
    j, t = JSeriesIndex(), TSeriesIndex()
    for tags in series:
        assert j.get_or_create("m", tags) == t.get_or_create("m", tags)
    return j, t


def _cases(rng, n):
    cases = []
    for _ in range(n):
        k = rng.choice(KEYS + ("missing_key",))
        op = rng.choice(("=", "!=", "=~", "!~"))
        v = (rng.choice(VALUES + ["absent-value"]) if op in ("=", "!=")
             else rng.choice(PATTERNS))
        cases.append((op, k, v))
    return cases


def _walk(idx, op, k, v):
    if op == "=":
        return idx.match_eq("m", k, v)
    if op == "!=":
        return idx.match_neq("m", k, v)
    return idx.match_regex("m", k, v, negate=op == "!~")


@pytest.fixture
def planners_off():
    """Both planners off: every route decision is its static prior."""
    was = (joffload.enabled(), toffload.enabled())
    joffload.set_enabled(False)
    toffload.set_enabled(False)
    yield
    joffload.set_enabled(was[0])
    toffload.set_enabled(was[1])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tier_matches_jax_tier_and_walk(seed):
    rng = random.Random(seed)
    j, t = _pair(_rand_series(rng, 500))
    jsnap = jlabels.tier_for(j).snapshot("m")
    tsnap = tlabels.tier_for(t).snapshot("m")
    assert np.array_equal(jsnap.sids, tsnap.sids)
    for op, k, v in _cases(rng, 150):
        got = tlabels.match_tier(tsnap, op, k, v)
        assert got.dtype == np.int64 and np.all(got[1:] > got[:-1])
        assert np.array_equal(got, jlabels.match_tier(jsnap, op, k, v)), \
            (op, k, v)
        assert set(got.tolist()) == _walk(t, op, k, v), (op, k, v)
        assert tsnap.estimate(op, k, v if op in ("=", "!=") else None) == \
            jsnap.estimate(op, k, v if op in ("=", "!=") else None)


def test_tag_compare_and_literal_head():
    rng = random.Random(5)
    j, t = _pair(_rand_series(rng, 300))
    jsnap = jlabels.tier_for(j).snapshot("m")
    tsnap = tlabels.tier_for(t).snapshot("m")
    for ka in KEYS + ("nokey",):
        for kb in KEYS + ("nokey2",):
            for eq in (True, False):
                assert np.array_equal(tsnap.match_tag_compare(ka, kb, eq),
                                      jsnap.match_tag_compare(ka, kb, eq))
    for p in PATTERNS + ["abc*d", "^pod-7.*", "ab?c", "x{2}"]:
        assert tlabels._literal_head(p) == jlabels._literal_head(p)


def test_regex_prefilter_over_many_values(monkeypatch):
    """High-distinct keys take the substring prefilter: same sids, and
    the LUT cache answers the repeat."""
    for mod in (jlabels, tlabels):
        monkeypatch.setattr(mod, "_PREFILTER_MIN_VALUES", 16)
    series = [(("pod", f"pod-{i}"), ("job", "api" if i % 3 else "web"))
              for i in range(200)]
    j, t = _pair(series)
    jsnap = jlabels.tier_for(j).snapshot("m")
    tsnap = tlabels.tier_for(t).snapshot("m")
    for p in ["pod-1.*", "^pod-7", "od-19", "zzz.*"]:
        for neg in (False, True):
            want = jsnap.match_regex("pod", p, negate=neg)
            assert np.array_equal(tsnap.match_regex("pod", p, negate=neg),
                                  want)
            assert np.array_equal(tsnap.match_regex("pod", p, negate=neg),
                                  want)


def test_knob_off_yields_no_tier(monkeypatch):
    monkeypatch.setenv("OGT_LABEL_INDEX", "0")
    _j, t = _pair(_rand_series(random.Random(0), 10))
    assert tlabels.tier_for(t) is None


# -- the mergeset index: tier-backed API, generations, staleness ---------------


@pytest.fixture
def midx():
    with tempfile.TemporaryDirectory() as d:
        idx = tmsi.MergesetIndex(d)
        yield idx
        idx.close()


def _plain_keys(series):
    return [",".join(["m"] + [f"{k}={v}" for k, v in tags
                              if "," not in v and " " not in v and v])
            for tags in series]


def test_mergeset_api_matches_walk_and_dict_index(midx):
    rng = random.Random(77)
    keys = _plain_keys(_rand_series(rng, 600))
    midx.get_or_create_bulk(keys)
    jidx = JSeriesIndex()
    for key in keys:
        parts = key.split(",")
        jidx.get_or_create("m", tuple(sorted(
            tuple(p.split("=", 1)) for p in parts[1:])))
    for op, k, v in _cases(rng, 150):
        got = _walk(midx, op, k, v)
        if op == "=":
            want = midx._match_eq_walk("m", k, v)
        elif op == "!=":
            want = midx._match_neq_walk("m", k, v)
        else:
            want = midx._match_regex_walk("m", k, v, negate=op == "!~")
        assert got == want, (op, k, v)
        # the JAX package's dict index numbers the same keys alike
        assert got == _walk(jidx, op, k, v), (op, k, v)


def test_mergeset_generations_and_staleness(midx, monkeypatch):
    midx.get_or_create_bulk(["m,job=a", "m,job=b"])
    g0 = midx.label_gen("m")
    assert midx.tag_values("m", "job") == ["a", "b"]
    assert len(midx.match_neq("m", "job", "a")) == 1
    builds = TSTATS.snapshot().get("index", {}).get("tier_builds_total", 0)
    # an insert bumps the measurement's generation: the snapshot and the
    # tag values rebuild
    midx.get_or_create("m", (("job", "c"),))
    assert midx.label_gen("m") > g0
    assert midx.tag_values("m", "job") == ["a", "b", "c"]
    assert len(midx.match_neq("m", "job", "a")) == 2
    assert TSTATS.snapshot()["index"]["tier_builds_total"] > builds
    # a removal bumps the index-wide epoch
    midx.remove_sids(midx.match_eq("m", "job", "b"))
    assert midx.label_gen("m")[0] == g0[0] + 1
    assert midx.match_eq("m", "job", "b") == set()
    assert midx.match_regex("m", "job", "b|c") == \
        midx._match_regex_walk("m", "job", "b|c")
    assert midx.match_eq("m", "job", "") == set()
    monkeypatch.setenv("OGT_LABEL_INDEX", "0")
    assert midx.match_neq("m", "job", "a") == \
        midx._match_neq_walk("m", "job", "a")


def test_mergeset_entries_bulk(midx):
    sids = midx.get_or_create_bulk(["m,dc=x,job=a", "n,job=b"])
    got = midx.entries_bulk(np.array(sids + [10_000], np.int64), cache=False)
    assert got[0] == ("m", (("dc", "x"), ("job", "a")))
    assert got[1] == ("n", (("job", "b"),))
    assert got[2] is None
    assert midx.entries_bulk(sids) == [midx.series_entry(s) for s in sids]


# -- the device route of the LUT gather ------------------------------------------


def test_device_route_on_cpu_tensors(monkeypatch, planners_off):
    monkeypatch.setenv("OGT_LABEL_INDEX_DEVICE", "1")
    for mod in (jlabels, tlabels):
        monkeypatch.setattr(mod, "_DEVICE_MIN_ROWS", 64)
    calls = []
    real = tlabels._gather_device

    def spy(col_idx, lut_ext, device):
        calls.append(str(device))
        return real(col_idx, lut_ext, device)

    monkeypatch.setattr(tlabels, "_gather_device", spy)
    rng = random.Random(31)
    j, t = _pair(_rand_series(rng, 600))
    jsnap = jlabels.tier_for(j).snapshot("m")
    tsnap = tlabels.tier_for(t).snapshot("m")
    for k in KEYS + ("missing_key",):
        for p in PATTERNS:
            for neg in (False, True):
                want = jsnap.match_regex(k, p, negate=neg)
                assert np.array_equal(
                    tsnap.match_regex(k, p, negate=neg, device="cpu"),
                    want), (k, p, neg)
                # no device: the host route, same sids
                assert np.array_equal(tsnap.match_regex(k, p, negate=neg),
                                      want)
    assert calls and set(calls) == {"cpu"}
    n = len(calls)
    # below the row threshold and with the knob at 0 the host answers
    monkeypatch.setenv("OGT_LABEL_INDEX_DEVICE", "0")
    tsnap.match_regex("job", "api-.*", device="cpu")
    assert len(calls) == n


def test_device_gather_clamps_and_raises(monkeypatch):
    lut = np.array([True, False, True])
    col = np.array([0, 1, 2, 2, 0], np.int32)
    assert np.array_equal(tlabels._gather_device(col, lut, "cpu"),
                          lut[col])

    class Boom(RuntimeError):
        pass

    def broken(*_a):
        raise Boom("device gather failed")

    monkeypatch.setattr(tlabels, "_gather_device", broken)
    monkeypatch.setenv("OGT_LABEL_INDEX_DEVICE", "1")
    monkeypatch.setattr(tlabels, "_DEVICE_MIN_ROWS", 1)
    _j, t = _pair(_rand_series(random.Random(2), 50))
    snap = tlabels.tier_for(t).snapshot("m")
    with pytest.raises(Boom):  # no hidden host fallback
        snap.match_regex("job", "a.*", device="cpu")


# -- query/condition.py and the PromQL matchers ----------------------------------


WHERES = [
    "job = 'api-1'",
    "job != 'web' AND region = 'eu'",
    "job =~ /api-.*/ OR region = 'us'",
    "pod !~ /a|eu/ AND (job = '' OR region != 'eu')",
    "job = region",
    "job != pod OR rare = 'a'",
    "job = ''",
    "missing = 'x' OR job =~ /^$/",
]


@pytest.mark.parametrize("where", WHERES)
def test_eval_tag_sids_through_the_tier(where, monkeypatch, planners_off):
    rng = random.Random(21)
    j, t = _pair(_rand_series(rng, 400))
    tq = tparse(f"select f from m where {where}")[0].condition
    jq = jparse(f"select f from m where {where}")[0].condition
    want = jcond.eval_tag_sids(jq, j, "m")
    assert np.array_equal(tcond.eval_tag_sids(tq, t, "m"), want)
    assert set(want.tolist()) == tcond.eval_tag_expr(tq, t, "m")
    monkeypatch.setenv("OGT_LABEL_INDEX_DEVICE", "1")
    monkeypatch.setattr(tlabels, "_DEVICE_MIN_ROWS", 64)
    assert np.array_equal(tcond.eval_tag_sids(tq, t, "m", "cpu"), want)


@pytest.mark.parametrize("where", ["job = 'api-1' AND f > 1",
                                   "job =~ /.*/ OR f < 0",
                                   "region = '' AND f = 2",
                                   "(pod = 'a' OR f > 3) AND job != 'web'"])
def test_superset_and_series_only_through_the_tier(where):
    rng = random.Random(22)
    j, t = _pair(_rand_series(rng, 300))
    tag_keys = set(KEYS)
    tq = tparse(f"select f from m where {where}")[0].condition
    jq = jparse(f"select f from m where {where}")[0].condition
    sup = tcond.tag_superset_arr(tq, t, "m", tag_keys)
    assert np.array_equal(sup, jcond.tag_superset_arr(jq, j, "m", tag_keys))
    assert set(sup.tolist()) == tcond.tag_superset_sids(tq, t, "m", tag_keys)
    ser = tcond.series_only_arr(tq, t, "m", tag_keys)
    assert np.array_equal(ser, jcond.series_only_arr(jq, j, "m", tag_keys))
    assert set(ser.tolist()) == tcond.series_only_sids(tq, t, "m", tag_keys)


class _Shard:
    def __init__(self, idx):
        self.index = idx


@pytest.mark.parametrize("matchers", [
    [("job", "=~", "api-.*"), ("region", "!=", "eu"), ("pod", "=", "web")],
    [("job", "=", "zzz"), ("job", "=~", "a.*")],
    [("rare", "!~", ""), ("pod", "=~", "a|eu")],
    [("__name__", "=", "m"), ("missing", "=", "")],
])
def test_match_sids_like_the_reference(matchers, monkeypatch):
    from opengemini_tpu.promql.engine import _match_sids as jmatch
    from opengemini_tpu.promql.parser import LabelMatcher as JLM
    from opengemini_tpu_torch.promql.engine import _match_sids as tmatch
    from opengemini_tpu_torch.promql.parser import LabelMatcher as TLM

    j, t = _pair(_rand_series(random.Random(9), 500))
    want = jmatch(_Shard(j), "m", [JLM(*m) for m in matchers])
    got = tmatch(_Shard(t), "m", [TLM(*m) for m in matchers])
    assert np.array_equal(got, want)
    monkeypatch.setenv("OGT_LABEL_INDEX", "0")
    assert np.array_equal(
        tmatch(_Shard(t), "m", [TLM(*m) for m in matchers]), want)


def test_match_sids_bad_regex_raises_like_the_reference():
    from opengemini_tpu_torch.promql.engine import PromError, _match_sids
    from opengemini_tpu_torch.promql.parser import LabelMatcher

    _j, t = _pair([(("job", "a"),)])
    with pytest.raises(PromError, match="invalid regex"):
        _match_sids(_Shard(t), "m", [LabelMatcher("job", "=", "zzz"),
                                     LabelMatcher("job", "=~", "([")])
