"""The port's castor detectors (services/castor.py), ``detect()`` and
CREATE, SHOW and DROP MODEL against the JAX package, on the CPU.

The detectors (mad, sigma, iqr, stl; ``robust_decompose``,
``stl_sudden_change``, ``fit``, ``detect_fitted``, ``StreamDetector``)
give the reference's masks and fitted parameters on the same arrays, bit
for bit. The SQL cases of the reference's tests/test_castor_depth.py
and tests/test_services.py (TestCastorModels, TestCastorUDF) run in both
packages on the same writes (the JAX ``Engine``/``Executor`` and the
port's ``Engine(device="cpu")``/``Executor``), each held to the
reference test's own checks, with equal answers, errors and model
artifacts (``fitted_at``, a wall clock, aside).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.services import castor as jc
from opengemini_tpu.storage import engine as jeng
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.services import castor as tc
from opengemini_tpu_torch.storage import engine as teng

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_040


def _seasonal_series(n=240, period=3, noise=0.05, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    prof = np.array([0.0, 2.0, -2.0])[t % period]
    return 10.0 + prof + rng.normal(0, noise, n)


def _bits(x) -> bytes:
    return np.asarray(x).tobytes()


def _model(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "fitted_at"}


# -- the detectors -------------------------------------------------------------

def _inputs(kind: str) -> np.ndarray:
    v = _seasonal_series()
    if kind == "spike":
        v[200] += 8.0
    elif kind == "dip":
        v[190] -= 8.0
    elif kind == "flat":
        v = np.full(40, 3.0)
    elif kind == "short":
        v = v[:7]
    elif kind == "walk":
        v = np.cumsum(np.random.default_rng(5).normal(0, 1, 300))
    elif kind == "empty":
        v = v[:0]
    return v


KINDS = ("clean", "spike", "dip", "flat", "short", "walk", "empty")


@pytest.mark.parametrize("algorithm", ["mad", "sigma", "iqr", "stl"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("threshold", [None, 2.0])
def test_detect_equals_the_reference(algorithm, kind, threshold):
    v = _inputs(kind)
    got = tc.detect(v, algorithm, threshold)
    want = jc.detect(v, algorithm, threshold)
    assert got.dtype == want.dtype and _bits(got) == _bits(want)


@pytest.mark.parametrize("algorithm", ["mad", "sigma", "iqr", "stl"])
@pytest.mark.parametrize("kind", ["clean", "spike", "walk", "flat"])
def test_fit_and_fitted_scoring_equal_the_reference(algorithm, kind):
    v = _inputs(kind)
    got, want = tc.fit(algorithm, v), jc.fit(algorithm, v)
    assert _model(got) == _model(want)
    for fresh in (_seasonal_series(seed=99), _seasonal_series(seed=99) + 6.0,
                  _seasonal_series(90, seed=42)[1:]):
        for thr in (None, 1.5):
            assert _bits(tc.detect_fitted(got, fresh, thr)) == _bits(
                jc.detect_fitted(want, fresh, thr))


def test_decompose_and_sudden_change():
    v = _seasonal_series()
    for period in (2, 3, 7):
        for a, b in zip(tc.robust_decompose(v, period),
                        jc.robust_decompose(v, period)):
            assert _bits(a) == _bits(b)
    trend, _s, resid, prof = tc.robust_decompose(v, period=3)
    assert abs(prof.mean()) < 1e-9
    assert prof[1] == pytest.approx(2.0, abs=0.3)
    assert resid.std() < 0.5
    spiked = v.copy()
    spiked[100] += 500.0
    assert abs(tc.robust_decompose(spiked, 3)[0][100] - 10.0) < 2.0
    for kind, at in (("spike", 200), ("dip", 190)):
        m = tc.stl_sudden_change(_inputs(kind))
        assert m[at] and m.sum() <= 3
        assert _bits(m) == _bits(jc.stl_sudden_change(_inputs(kind)))
    assert tc.stl_sudden_change(v).sum() == 0
    p = {"sensitivity": 2.0, "top_percent": 0.2}
    assert _bits(tc.stl_sudden_change(v, p)) == _bits(
        jc.stl_sudden_change(v, p))


def test_fit_errors_equal_the_reference():
    for args in (("mad", np.arange(5.0)), ("nope", np.arange(20.0)),
                 ("sigma", np.array([1.0] * 4 + [np.nan] * 10))):
        errs = []
        for mod in (jc, tc):
            with pytest.raises(ValueError) as ei:
                mod.fit(*args)
            errs.append(str(ei.value))
        assert errs[1] == errs[0]
    for mod in (jc, tc):
        with pytest.raises(ValueError, match="unknown"):
            mod.detect(np.arange(10.0), "nope")


@pytest.mark.parametrize("algorithm,model", [
    ("sigma", False), ("mad", False), ("iqr", False), ("stl", True)])
def test_stream_detector_equals_the_reference(algorithm, model):
    v = _seasonal_series()
    v[220] += 9.0
    kw = {}
    if model:
        kw["model"] = tc.fit(algorithm, _seasonal_series())
    sd_t = tc.StreamDetector(algorithm, history=1024, **kw)
    if model:
        kw["model"] = jc.fit(algorithm, _seasonal_series())
    sd_j = jc.StreamDetector(algorithm, history=1024, **kw)
    got = np.concatenate([sd_t.push(v[lo:lo + 40])
                          for lo in range(0, len(v), 40)])
    want = np.concatenate([sd_j.push(v[lo:lo + 40])
                           for lo in range(0, len(v), 40)])
    assert _bits(got) == _bits(want)
    assert got.shape == v.shape
    if algorithm == "sigma":
        assert got[220]
    sd = tc.StreamDetector("mad", history=64)
    for _ in range(100):
        sd.push(np.ones(10))
    assert len(sd._ring) == 64
    with pytest.raises(ValueError, match="unknown"):
        tc.StreamDetector("nope")


# -- the SQL surface ------------------------------------------------------------

class Env:
    def __init__(self, name, root):
        if name == "jax":
            self.e = jeng.Engine(str(root))
            self.ex = JExecutor(self.e)
            self.castor = jc
        else:
            self.e = teng.Engine(str(root), device="cpu")
            self.ex = TExecutor(self.e)
            self.castor = tc
        if "db" not in self.e.databases:
            self.e.create_database("db")

    def q(self, text):
        return self.ex.execute(text, db="db", now_ns=(BASE + 10_000) * NS)


def both(tmp_path, scenario):
    """`scenario(env)` in both packages; the port's outcome equals the
    JAX package's."""
    outs = []
    for name in ("jax", "torch"):
        env = Env(name, tmp_path / name)
        try:
            outs.append(scenario(env))
        finally:
            env.e.close()
    assert outs[1] == outs[0]
    return outs[1]


def test_detect_sql_surface(tmp_path):
    def scenario(env):
        v = _seasonal_series(120)
        v[100] += 9.0
        env.e.write_lines("db", "\n".join(
            f"m value={x} {(BASE + i) * NS}" for i, x in enumerate(v)))
        out = {}
        for alg in ("stl", "mad", "sigma", "iqr"):
            res = env.q(f"SELECT detect(value, '{alg}') FROM m")
            out[alg] = res
            rows = res["results"][0]["series"][0]["values"]
            assert (BASE + 100) * NS in {r[0] for r in rows}
        out["thr"] = env.q("SELECT detect(value, 'sigma', 1.0) FROM m "
                           "GROUP BY time(30s)")
        return out

    both(tmp_path, scenario)


def test_create_model_sql_roundtrip(tmp_path):
    def scenario(env):
        v = _seasonal_series(120)
        env.e.write_lines("db", "\n".join(
            f"m value={x} {(BASE + i) * NS}" for i, x in enumerate(v)))
        res = env.q("CREATE MODEL seasonal1 WITH ALGORITHM 'stl' FROM "
                    "(SELECT value FROM m)")
        assert "error" not in res["results"][0], res
        names = [r[0] for r in env.q("SHOW MODELS")["results"][0]
                 ["series"][0]["values"]]
        assert "seasonal1" in names
        env.e.write_lines("db", "\n".join(
            f"m2 value={x + 7.0} {(BASE + i) * NS}"
            for i, x in enumerate(_seasonal_series(30, seed=5))))
        res = env.q("SELECT detect(value, 'seasonal1') FROM m2")
        rows = res["results"][0]["series"][0]["values"]
        assert len(rows) == 30  # every shifted point flagged
        return res, _model(env.e.models.get("seasonal1"))

    both(tmp_path, scenario)


def test_fit_persist_detect_roundtrip(tmp_path):
    def scenario(env):
        lines = [f"m v={10 + (i % 3)} {(BASE + i) * NS}" for i in range(60)]
        lines += [f"m v=11 {(BASE + 100) * NS}",
                  f"m v=500 {(BASE + 101) * NS}"]
        env.e.write_lines("db", "\n".join(lines))
        r = env.q("CREATE MODEL calm WITH ALGORITHM 'mad' FROM "
                  f"(SELECT v FROM m WHERE time < {(BASE + 60) * NS})")
        assert "error" not in r["results"][0], r
        doc = env.e.models.get("calm")
        assert doc["algorithm"] == "mad" and doc["trained_rows"] == 60
        q = f"SELECT detect(v, 'calm') FROM m WHERE time >= {(BASE + 100) * NS}"
        vals = env.q(q)["results"][0]["series"][0]["values"]
        assert [v[1] for v in vals] == [500.0]
        row = env.q("SHOW MODELS")["results"][0]["series"][0]["values"][0]
        assert row[0] == "calm" and row[1] == "mad" and row[3] == 60
        return _model(doc), vals, row[:4]

    outs = both(tmp_path, scenario)
    # a restart keeps the model, DROP MODEL removes it, in either package
    # reading the root the other wrote
    for name, other in (("jax", "torch"), ("torch", "jax")):
        env = Env(name, tmp_path / other)
        try:
            q = (f"SELECT detect(v, 'calm') FROM m "
                 f"WHERE time >= {(BASE + 100) * NS}")
            got = env.q(q)["results"][0]["series"][0]["values"]
            assert got == outs[1]
            with open(tmp_path / other / "models" / "calm.json") as f:
                assert _model(json.load(f)) == outs[0]
        finally:
            env.e.close()
    errs = []
    for name in ("jax", "torch"):
        env = Env(name, tmp_path / name)
        try:
            env.q("DROP MODEL calm")
            assert env.e.models.get("calm") is None
            errs.append((env.q("SELECT detect(v, 'calm') FROM m"),
                         env.q("DROP MODEL calm"), env.q("SHOW MODELS")))
        finally:
            env.e.close()
    assert errs[1] == errs[0]
    assert "error" in errs[1][0]["results"][0]


@pytest.mark.parametrize("stmt", [
    "CREATE MODEL mad WITH ALGORITHM 'mad' FROM (SELECT v FROM m)",
    "CREATE MODEL tiny WITH ALGORITHM 'sigma' FROM (SELECT v FROM m)",
    "CREATE MODEL odd WITH ALGORITHM 'nope' FROM (SELECT v FROM m)",
    "CREATE MODEL .hidden WITH ALGORITHM 'mad' FROM (SELECT v FROM m)",
])
def test_fit_rejects_builtin_shadow_and_thin_data(tmp_path, stmt):
    def scenario(env):
        env.e.write_lines("db", f"m v=1 {BASE * NS}")
        return env.q(stmt)

    res = both(tmp_path, scenario)
    err = res["results"][0].get("error", "")
    if "mad WITH" in stmt:
        assert "shadows" in err
    if "tiny" in stmt:
        assert ">= 8" in err


def test_udfs_load_and_run_via_sql(tmp_path):
    udf_dir = tmp_path / "udfs"
    udf_dir.mkdir()
    (udf_dir / "spike.py").write_text(
        "def detect(values, threshold):\n"
        "    thr = 100.0 if threshold is None else threshold\n"
        "    return values > thr\n")
    (udf_dir / "broken.py").write_text("def detect(:\n")  # a syntax error
    (udf_dir / "mad.py").write_text("def detect(v, t): return v > 0\n")
    (udf_dir / "badshape.py").write_text(
        "def detect(values, threshold):\n    return values[:1] > 0\n")
    (udf_dir / "wrongarity.py").write_text(
        "def detect(values):\n    return values > 0\n")

    def scenario(env):
        try:
            loaded = env.castor.load_udfs(str(udf_dir))
            assert loaded == ["badshape", "spike", "wrongarity"]
            env.e.write_lines("db", "\n".join(
                f"m v={v} {(BASE + i) * NS}"
                for i, v in enumerate([1, 2, 500, 3])))
            out = [env.q("SELECT detect(v, 'spike') FROM m"),
                   env.q("SELECT detect(v, 'spike', 2.5) FROM m"),
                   env.q("SELECT detect(v, 'nope') FROM m"),
                   env.q("SELECT detect(v, 'badshape') FROM m"),
                   env.q("SELECT detect(v, 'wrongarity') FROM m")]
            assert [r[1] for r in out[0]["results"][0]["series"][0]
                    ["values"]] == [500.0]
            assert [r[1] for r in out[1]["results"][0]["series"][0]
                    ["values"]] == [500.0, 3.0]
            assert "spike" in out[2]["results"][0]["error"]
            assert "expected (4,)" in out[3]["results"][0]["error"]
            err = out[4]["results"][0]["error"]
            assert "wrongarity" in err and "failed" in err
            # a reload replaces the set
            (udf_dir / "spike.py").unlink()
            assert env.castor.load_udfs(str(udf_dir)) == [
                "badshape", "wrongarity"]
            out.append(env.q("SELECT detect(v, 'spike') FROM m"))
            (udf_dir / "spike.py").write_text(
                "def detect(values, threshold):\n"
                "    thr = 100.0 if threshold is None else threshold\n"
                "    return values > thr\n")
            return out
        finally:
            env.castor._UDFS.clear()

    both(tmp_path, scenario)
