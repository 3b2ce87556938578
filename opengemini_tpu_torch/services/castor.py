"""Anomaly detection (castor analogue).

The port of ``opengemini_tpu/services/castor.py``, whole: host numpy,
as in the reference (the series a detector scores are read by the
query path, query/hostpath.py; a model's training SELECT runs on the
engine's device).

Reference: services/castor + python/ts-udf — openGemini ships anomaly
detection as a Python sidecar driven through UDAF calls. This framework IS
Python on the query side, so the algorithms run in-process behind the
`detect(field, 'algorithm'[, threshold])` SQL function (host multi-row
path) — no sidecar protocol needed; heavier ML detectors can still hook
in here later.

Algorithms (the reference agent's classic detectors):
  mad    — robust z-score via median absolute deviation (default thr 3.0)
  sigma  — z-score against mean/stddev (default thr 3.0)
  iqr    — Tukey fences, thr x IQR beyond the quartiles (default thr 1.5)
"""

from __future__ import annotations

import numpy as np

ALGORITHMS = ("mad", "sigma", "iqr", "stl")

# user detectors loaded from [services] castor-udf-dir: name -> callable
# (reference: python/ts-udf pluggable algorithm scripts)
_UDFS: dict[str, object] = {}


def load_udfs(directory: str) -> list[str]:
    """Load every `<name>.py` in `directory` as a detector UDF. Each file
    must define `detect(values: np.ndarray, threshold: float|None)
    -> np.ndarray[bool]`. A broken file is skipped with a log line, never
    taking the server down. Returns the loaded names."""
    import logging
    import os

    log = logging.getLogger("opengemini_tpu_torch.castor")
    loaded = []
    _UDFS.clear()  # idempotent reload: stale detectors must not linger
    if not os.path.isdir(directory):
        return loaded
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        name = fname[:-3].lower()
        if name in ALGORITHMS:
            log.warning("castor udf %r shadows a built-in; skipped", name)
            continue
        path = os.path.join(directory, fname)
        ns: dict = {"np": np, "numpy": np}
        try:
            with open(path, encoding="utf-8") as f:
                exec(compile(f.read(), path, "exec"), ns)  # noqa: S102
            fn = ns.get("detect")
            if not callable(fn):
                raise TypeError("no detect(values, threshold) function")
        except Exception:  # noqa: BLE001
            log.exception("castor udf %s failed to load", path)
            continue
        _UDFS[name] = fn
        loaded.append(name)
    return loaded


# -- robust seasonal decomposition (original; fills the role of the
# reference's STL-based sudden-increase pipeline,
# python/ts-udf/server/udf/sudden_increase_STL3.py, without statsmodels) --


def _running_median(v: np.ndarray, window: int) -> np.ndarray:
    """Odd-window running median with edge replication — the robust
    trend extractor (outliers cannot drag a median trend)."""
    half = window // 2
    padded = np.concatenate([np.full(half, v[0]), v, np.full(half, v[-1])])
    shape = (len(v), window)
    strides = (padded.strides[0], padded.strides[0])
    mat = np.lib.stride_tricks.as_strided(padded, shape, strides)
    return np.median(mat, axis=1)


def robust_decompose(v: np.ndarray, period: int = 3):
    """(trend, seasonal, resid): running-median trend over ~2 periods,
    per-phase median seasonal profile (centered), remainder residual."""
    n = len(v)
    period = max(int(period), 2)
    win = min(2 * period + 1, n if n % 2 else n - 1)
    win = max(win, 3)
    trend = _running_median(v, win)
    detr = v - trend
    phases = np.arange(n) % period
    seasonal_prof = np.zeros(period)
    for p in range(period):
        sel = detr[phases == p]
        if len(sel):
            seasonal_prof[p] = np.median(sel)
    seasonal_prof -= seasonal_prof.mean()  # centered, like STL
    seasonal = seasonal_prof[phases]
    resid = v - trend - seasonal
    return trend, seasonal, resid, seasonal_prof


# sudden-increase defaults (reference hyper_params,
# sudden_increase_STL3.py:30-37)
_STL_DEFAULTS = {
    "period": 3,
    "std_window": 20,
    "sensitivity": 3.0,
    "resid_weight": 2.0,
    "trend_weight": 3.0,
    "all_weight": 3.0,
    "top_percent": 0.5,
}


def _mean_std_indices(seq: np.ndarray, weight: float) -> np.ndarray:
    """Indices beyond mean ± weight*std, both directions."""
    m, s = float(seq.mean()), float(seq.std())
    return np.flatnonzero(np.abs(seq - m) > weight * s)


def stl_sudden_change(v: np.ndarray, params: dict | None = None
                      ) -> np.ndarray:
    """Sudden increase/decrease detection via robust decomposition:
    candidates = outliers of the residual, the trend, and the raw values
    of the scored half against the reference half; each candidate then
    scores against a local sliding window (flagged points excluded, std
    floored at 5% of the local mean) and only the top-scoring fraction
    survives. Same pipeline shape as the reference's STL3 detector;
    the decomposition is the original numpy one above."""
    p = dict(_STL_DEFAULTS)
    if params:
        p.update(params)
    n = len(v)
    if n < 8:
        return np.zeros(n, dtype=bool)
    start = n // 2 if n > 60 else max(n - 30, 0)
    trend, _seasonal, resid, _prof = robust_decompose(v, int(p["period"]))
    cand = set(_mean_std_indices(resid, p["resid_weight"]).tolist())
    cand |= set(_mean_std_indices(trend, p["trend_weight"]).tolist())
    ref = v[:start] if start else v
    m, s = float(ref.mean()), float(ref.std())
    tail = np.flatnonzero(np.abs(v[start:] - m) > p["all_weight"] * s)
    cand |= set((tail + start).tolist())
    if not cand:
        return np.zeros(n, dtype=bool)
    cand_arr = np.array(sorted(cand))
    scored_idx, scores = [], []
    w = int(p["std_window"])
    for i in cand_arr[cand_arr >= start]:
        lo = max(int(i) - w, 0)
        window = v[lo:int(i)]
        keep = np.setdiff1d(np.arange(lo, int(i)), cand_arr,
                            assume_unique=False) - lo
        clean = window[keep] if len(keep) else window
        if len(clean) == 0:
            clean = ref
        wm, ws = float(clean.mean()), float(clean.std())
        floor = abs(wm) * 0.05
        ws = max(ws, floor, 1e-12)
        dev = abs(float(v[int(i)]) - wm)
        if dev > p["sensitivity"] * ws:
            scored_idx.append(int(i))
            scores.append(dev / ws)
    mask = np.zeros(n, dtype=bool)
    if not scores:
        return mask
    cutoff = max(scores) * float(p["top_percent"])
    for i, sc in zip(scored_idx, scores):
        if sc >= cutoff:
            mask[i] = True
    return mask


def _baseline(algorithm: str, v: np.ndarray,
              threshold: float | None) -> tuple[float, dict]:
    """(threshold, fitted params) for a builtin algorithm — the ONE place
    the formulas and default thresholds live (stateless detect, fit, and
    fitted detect all share it)."""
    if algorithm == "stl":
        # fit = learn the seasonal profile + residual spread of the
        # TRAINING window (reference PipelineDetector.fit_run persists
        # the pipeline state; fit_detect.py:32)
        thr = (_STL_DEFAULTS["sensitivity"] if threshold is None
               else float(threshold))
        period = _STL_DEFAULTS["period"]
        trend, _seas, resid, prof = robust_decompose(v, period)
        return thr, {
            "period": period,
            "seasonal": [float(x) for x in prof],
            "level": float(np.median(trend[-2 * period:])),
            "resid_std": float(max(resid.std(), 1e-12)),
        }
    if algorithm == "mad":
        thr = 3.0 if threshold is None else float(threshold)
        med = float(np.median(v))
        return thr, {"median": med,
                     "mad": float(np.median(np.abs(v - med)))}
    if algorithm == "sigma":
        thr = 3.0 if threshold is None else float(threshold)
        return thr, {"mean": float(v.mean()), "std": float(v.std())}
    if algorithm == "iqr":
        thr = 1.5 if threshold is None else float(threshold)
        q1, q3 = np.percentile(v, [25, 75])
        return thr, {"q1": float(q1), "q3": float(q3)}
    raise ValueError(f"unknown algorithm {algorithm!r}")


def _score(algorithm: str, params: dict, thr: float,
           v: np.ndarray) -> np.ndarray:
    if algorithm == "stl":
        if "seasonal" not in params:
            # stateless detect(): run the full sudden-change pipeline on
            # the scored window itself
            return stl_sudden_change(v, {"sensitivity": thr})
        # fitted: score against the TRAINED seasonal profile + level.
        # The scored window carries no timestamps, so its phase origin
        # is unknown — align by best fit: try every cyclic offset of the
        # profile and keep the one minimizing total absolute deviation
        # (a mis-anchored phase would turn the seasonal amplitude itself
        # into systematic false anomalies)
        prof = np.asarray(params["seasonal"], dtype=np.float64)
        period = int(params["period"])
        idx = np.arange(len(v))
        best_dev = None
        for off in range(period):
            expected = params["level"] + prof[(idx + off) % period]
            dev = np.abs(v - expected)
            if best_dev is None or dev.sum() < best_dev.sum():
                best_dev = dev
        return best_dev / params["resid_std"] > thr
    if algorithm == "mad":
        med, mad = params["median"], params["mad"]
        if mad == 0:
            return v != med
        return np.abs(v - med) / (1.4826 * mad) > thr
    if algorithm == "sigma":
        if params["std"] == 0:
            return np.zeros(len(v), dtype=bool)
        return np.abs(v - params["mean"]) / params["std"] > thr
    if algorithm == "iqr":
        iqr = params["q3"] - params["q1"]
        return (v < params["q1"] - thr * iqr) | (v > params["q3"] + thr * iqr)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def detect(values: np.ndarray, algorithm: str, threshold: float | None = None) -> np.ndarray:
    """Boolean anomaly mask over a value series (stateless: the baseline
    is fitted on the same window it scores)."""
    algorithm = algorithm.lower()
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=bool)
    v = values.astype(np.float64)
    if algorithm == "stl":
        # stateless: the sudden-change pipeline fits and scores the same
        # window (threshold overrides the sensitivity)
        params = {} if threshold is None else {"sensitivity": float(threshold)}
        return stl_sudden_change(v, params)
    if algorithm in ALGORITHMS:
        thr, params = _baseline(algorithm, v, threshold)
        return _score(algorithm, params, thr, v)
    udf = _UDFS.get(algorithm)
    if udf is not None:
        try:
            mask = np.asarray(udf(v, threshold))
        except ValueError:
            raise
        except Exception as e:  # noqa: BLE001 — udf bugs become clean errors
            raise ValueError(f"udf {algorithm!r} failed: {e}") from e
        if mask.shape != (n,):
            raise ValueError(
                f"udf {algorithm!r} returned shape {mask.shape}, "
                f"expected ({n},)"
            )
        return mask.astype(bool)
    names = list(ALGORITHMS) + sorted(_UDFS)
    raise ValueError(f"unknown detect algorithm {algorithm!r} "
                     f"(supported: {', '.join(names)})")


# -- fitted models (reference: the castor fit pipeline + model lifecycle,
# services/castor/service.go:32-143, python/ts-udf/server) ------------------

import json as _json
import os as _os
import time as _time

from opengemini_tpu_torch.utils import lockdep


def fit(algorithm: str, values: np.ndarray, threshold: float | None = None) -> dict:
    """Train a detector on a value series: learn the baseline statistics
    the algorithm needs so later detect() calls score NEW data against
    the TRAINING window (the point of fit vs stateless detection)."""
    algorithm = algorithm.lower()
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    if len(v) < 8:
        raise ValueError(f"model fit needs >= 8 finite points, got {len(v)}")
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"unknown fit algorithm {algorithm!r} "
            f"(supported: {', '.join(ALGORITHMS)})")
    thr, params = _baseline(algorithm, v, threshold)
    return {
        "algorithm": algorithm,
        "threshold": thr,
        "params": params,
        "trained_rows": int(len(v)),
        # wall-clock record: model provenance shown to operators
        "fitted_at": int(_time.time()),  # ogtlint: disable=OGT040
    }


def detect_fitted(model: dict, values: np.ndarray,
                  threshold: float | None = None) -> np.ndarray:
    """Score values against a fitted model's training baseline. An
    explicit query-time threshold overrides the persisted one."""
    v = np.asarray(values, dtype=np.float64)
    thr = float(model["threshold"]) if threshold is None else float(threshold)
    return _score(model["algorithm"], model["params"], thr, v)


class StreamDetector:
    """Incremental (at-ingest) scoring — the stream entry point next to
    the batch detect() SQL surface (reference: castor's batch vs stream
    handlers, python/ts-udf/server/handler.py). Keeps a bounded history
    ring; each push() scores ONLY the new points, against the fitted
    model when one is attached, else against the stateless algorithm
    over history + new points."""

    def __init__(self, algorithm: str, threshold: float | None = None,
                 model: dict | None = None, history: int = 512):
        self.algorithm = algorithm.lower()
        self.threshold = threshold
        self.model = model
        self.history = int(history)
        self._ring = np.empty(0, dtype=np.float64)
        if self.algorithm not in ALGORITHMS and self.algorithm not in _UDFS:
            raise ValueError(f"unknown detect algorithm {algorithm!r}")

    def push(self, values: np.ndarray) -> np.ndarray:
        v = np.asarray(values, dtype=np.float64)
        if len(v) == 0:
            return np.zeros(0, dtype=bool)
        if self.model is not None:
            mask = detect_fitted(self.model, v, self.threshold)
        else:
            window = np.concatenate([self._ring, v])
            mask = detect(window, self.algorithm, self.threshold)[
                len(self._ring):]
        self._ring = np.concatenate([self._ring, v])[-self.history:]
        return mask


class ModelStore:
    """Persisted fitted models: one JSON artifact per model under
    <engine-root>/models/ (atomic replace on save, reloaded on open —
    the reference keeps model files under the castor sidecar's model
    dirs with version counters)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = lockdep.Lock()
        _os.makedirs(path, exist_ok=True)

    def _file(self, name: str) -> str:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"bad model name {name!r}")
        return _os.path.join(self.path, name + ".json")

    def save(self, name: str, doc: dict) -> None:
        with self._lock:
            tmp = self._file(name) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                _json.dump(doc, f)
                f.flush()
                _os.fsync(f.fileno())
            _os.replace(tmp, self._file(name))

    def get(self, name: str) -> dict | None:
        try:
            with open(self._file(name), encoding="utf-8") as f:
                return _json.load(f)
        except (OSError, ValueError):
            return None

    def names(self) -> list[str]:
        return sorted(
            f[:-5] for f in _os.listdir(self.path) if f.endswith(".json"))

    def drop(self, name: str) -> bool:
        with self._lock:
            try:
                _os.remove(self._file(name))
                return True
            except OSError:
                return False
