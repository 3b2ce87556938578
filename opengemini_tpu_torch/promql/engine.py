"""PromQL evaluation engine over the storage engine + device kernels.

Reference path: servePromRead -> promql2influxql.Transpile -> influx SELECT
with prom logical nodes + prom cursors (SURVEY.md §3.3). Here the AST
evaluates directly: selectors scan the same shards/index as InfluxQL, the
range-vector math runs in ops/prom.py device kernels over dense
(series, steps) grids, and label aggregation happens on the host.

Data model (matching the reference's prom-on-influx mapping): metric name
= measurement, labels = tags, sample value = field "value".

The port of ``opengemini_tpu/promql/engine.py`` for one device. The
kernels run on the device of the Engine the PromEngine serves: the
tiled kernels on the host (numpy) or on the device (torch) as the
offload planner routes them, where a CPU engine's static route is the
host and a CUDA engine's the device; the dense kernels (torch) on the
engine's device. With a device mesh configured (parallel/runtime.py)
the tiled kernels' static route is "mesh": their series axis splits
over the mesh's shards (ops/prom.py ``ShardedTiled``), which
OGT_PROM_MESH=0 opts out of. An evaluation is noted in the slow-query log (utils/slowlog.py);
the governor's admission is taken by the HTTP routes (server/http.py).
Knobs: OGT_PROM_TILED, OGT_PROM_BULK_SIDS, OGT_PROM_TILE_CELLS and the
offload planner's host-kernels switch (OGT_PROM_HOST_KERNELS,
/debug/ctrl?mod=offload&host_kernels=).
"""

from __future__ import annotations

import math
import os
import re
import time as _time
from contextlib import contextmanager

import numpy as np
import torch

from opengemini_tpu_torch.ops import prom as promops
from opengemini_tpu_torch.promql import parser as pp
from opengemini_tpu_torch.utils import devobs
from opengemini_tpu_torch.utils import tracing
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER
from opengemini_tpu_torch.utils.slowlog import GLOBAL as SLOWLOG
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

MS = 1_000_000  # ns per ms
DEFAULT_LOOKBACK_S = 300.0


class PromError(ValueError):
    pass


# -- tiled-engine knobs (documented in README "PromQL engine") -----------


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _tiled_enabled() -> bool:
    return os.environ.get("OGT_PROM_TILED", "1") != "0"


def _bulk_sids_min() -> int:
    return max(1, _env_int("OGT_PROM_BULK_SIDS", 1))


def _tile_cells_mult() -> int:
    return max(1, _env_int("OGT_PROM_TILE_CELLS", 8))


class _EncSlice:
    """One series' untrimmed all-valid slice of a still-encoded bulk
    value column (record.EncodedColumn) — resolved at assembly into
    either a (ftype, blocks, segments, slices) device-decode
    descriptor or, on any
    fallback, the decoded values."""

    __slots__ = ("col", "lo", "hi")

    def __init__(self, col, lo: int, hi: int):
        self.col = col
        self.lo = lo
        self.hi = hi


def _materialize_slice(v):
    if isinstance(v, _EncSlice):
        # slice BEFORE the astype: converting the whole column per
        # slice would be O(series x column) copies on fallback
        return v.col.values[v.lo:v.hi].astype(np.float64)
    return v


def _assemble_enc(v_parts):
    """(ftype, blocks, segments, slices) when every per-series part
    is a slice of
    ONE still-encoded column, else None (values materialize eagerly)."""
    col = None
    slices = []
    for v in v_parts:
        if not isinstance(v, _EncSlice):
            return None
        if col is None:
            col = v.col
        elif v.col is not col:
            return None  # cross-shard/cross-column: host merge path
        slices.append((v.lo, v.hi))
    if col is None or col.is_decoded:
        return None
    return (col.ftype, tuple(col.blocks), col.segments, tuple(slices))


def _want_encoded(device) -> bool:
    """Collect still-encoded value columns only when the device route of
    the tiled kernels will run (device decode is pointless under host
    kernels) and the device decoder is on."""
    if _host_kernels(device):
        return False
    from opengemini_tpu_torch.ops import device_decode

    return device_decode.active()


def _host_kernels(device) -> bool:
    """numpy (host) vs torch on `device` for the tiled kernels' static
    route: a CPU engine answers in numpy, a CUDA engine on the card.
    OGT_PROM_HOST_KERNELS resolves ONCE through the offload knob layer
    (hot-reloadable via /debug/ctrl?mod=offload) — not re-read from the
    environment on every evaluation."""
    from opengemini_tpu_torch.query import offload

    v = offload.prom_host_kernels_mode()
    if v == "1":
        return True
    if v == "0":
        return False
    return torch.device(device).type == "cpu"


def _mesh_for_tiled():
    """The configured device mesh when the tiled kernels should split
    their series axis over it (ops/prom.py ShardedTiled). A set mesh
    overrides the host-kernel CPU shortcut — running over the mesh is
    the point of configuring one; OGT_PROM_MESH=0 opts the PromQL engine
    out (grid and bucketed batches keep their own mesh paths)."""
    if os.environ.get("OGT_PROM_MESH", "1") == "0":
        return None
    from opengemini_tpu_torch.parallel import runtime

    return runtime.get_mesh()


@contextmanager
def _stage(name: str):
    """Per-stage attribution: /debug/vars query_stages + the per-query
    stage map in /debug/queries and the slow-query log."""
    t0 = _time.perf_counter_ns()
    try:
        yield
    finally:
        ns = _time.perf_counter_ns() - t0
        tracing.record_stage(name, ns)
        TRACKER.add_stage_ns(TRACKER.current_qid(), name, ns)


def _anchor(pattern: str) -> str:
    return "^(?:" + pattern + ")$"


def _match_sids(sh, metric: str, matchers, device=None) -> np.ndarray:
    """Series ids matching prom label matchers, as a SORTED unique
    int64 array (prometheus fully anchors label-matcher regexes). The
    columnar label tier (index.labels) answers each matcher with a
    posting array and composition is np.intersect1d, matchers ordered
    cheapest-first; with the tier knob-disabled the legacy set walk
    runs and the result converts — same sids either way. A regex
    matcher's LUT gather may route to `device` (None: host only)."""
    from opengemini_tpu_torch.index import labels as _labels

    tier = _labels.tier_for(sh.index)
    if tier is not None:
        return _match_sids_tier(tier, metric, matchers, device)
    sids = sh.index.series_ids(metric)
    for m in matchers:
        if m.name == "__name__":
            continue
        try:
            if m.op == "=":
                sids &= sh.index.match_eq(metric, m.name, m.value)
            elif m.op == "!=":
                sids &= sh.index.match_neq(metric, m.name, m.value)
            elif m.op == "=~":
                sids &= sh.index.match_regex(metric, m.name, _anchor(m.value))
            elif m.op == "!~":
                sids &= sh.index.match_regex(
                    metric, m.name, _anchor(m.value), negate=True
                )
        except re.error as e:
            raise PromError(f"invalid regex in matcher {m.name!r}: {e}") from None
    if not sids:
        return np.empty(0, np.int64)
    return np.fromiter(sorted(sids), np.int64, len(sids))


def _match_sids_tier(tier, metric: str, matchers,
                     device=None) -> np.ndarray:
    from opengemini_tpu_torch.index import labels as _labels

    snap = tier.snapshot(metric)
    ms = [m for m in matchers
          if m.name != "__name__" and m.op in ("=", "!=", "=~", "!~")]
    if not ms:
        return snap.sids
    for m in ms:
        if m.op in ("=~", "!~"):
            try:
                re.compile(_anchor(m.value))  # re caches the program
            except re.error as e:
                raise PromError(
                    f"invalid regex in matcher {m.name!r}: {e}") from None
    # cheapest matcher first: its postings bound every later intersect,
    # and an empty prefix short-circuits the regex automaton passes
    est = [snap.estimate(m.op, m.name,
                         m.value if m.op in ("=", "!=") else None)
           for m in ms]
    order = sorted(range(len(ms)), key=est.__getitem__)
    if order != list(range(len(ms))):
        STATS.incr("index", "matcher_reorders_total")
    sids = None
    for i in order:
        m = ms[i]
        if m.op == "=":
            cur = snap.match_eq(m.name, m.value)
        elif m.op == "!=":
            cur = snap.match_neq(m.name, m.value)
        elif m.op == "=~":
            cur = snap.match_regex(m.name, _anchor(m.value),
                                   head=_labels._literal_head(m.value),
                                   device=device)
        else:
            cur = snap.match_regex(m.name, _anchor(m.value), negate=True,
                                   head=_labels._literal_head(m.value),
                                   device=device)
        sids = cur if sids is None else np.intersect1d(
            sids, cur, assume_unique=True)
        if sids.size == 0:
            return sids
    return sids


class Frame:
    """Evaluation result: per-series (S, K) values over the step grid."""

    __slots__ = ("labels", "values", "valid", "is_scalar")

    def __init__(self, labels, values, valid, is_scalar=False):
        self.labels = labels  # list[dict]
        self.values = values  # (S, K) float
        self.valid = valid  # (S, K) bool
        self.is_scalar = is_scalar

    @classmethod
    def scalar(cls, v: float, k: int):
        return cls([{}], np.full((1, k), v), np.ones((1, k), bool), True)


class PromEngine:
    def __init__(self, engine, value_field: str = "value",
                 lookback_s: float = DEFAULT_LOOKBACK_S):
        self.engine = engine
        self.device = engine.device
        self.value_field = value_field
        self.lookback_s = lookback_s

    # -- public API -----------------------------------------------------

    def query_range(self, text: str, start_s: float, end_s: float, step_s: float,
                    db: str) -> dict:
        self._check_readable()
        if step_s <= 0:
            raise PromError("step must be positive")
        if not (math.isfinite(start_s) and math.isfinite(end_s) and math.isfinite(step_s)):
            raise PromError("start/end/step must be finite")
        n_steps = int(math.floor((end_s - start_s) / step_s)) + 1
        if n_steps <= 0:
            raise PromError("empty step range")
        if n_steps > 11_000:
            raise PromError("too many steps (max 11000)")
        steps = start_s + np.arange(n_steps) * step_s
        expr = pp.parse(text)
        with self._tracked(text, db):
            frame = self._eval(expr, steps, db)
        with _stage("render"):
            # Python floats and bools once: element access on numpy
            # arrays costs a scalar object per point
            ts = steps.astype(np.float64).tolist()
            vals = frame.values.astype(np.float64).tolist()
            valid = frame.valid.tolist()
            result = []
            for labels, row, ok in zip(frame.labels, vals, valid):
                # a finite v (v - v == 0) formats as _fmt does, by repr
                pts = [[t, repr(v) if v - v == 0 else _fmt(v)]
                       for t, v, o in zip(ts, row, ok) if o]
                if pts:
                    result.append({"metric": labels, "values": pts})
            result.sort(key=lambda r: sorted(r["metric"].items()))
        return {"resultType": "matrix", "result": result}

    def query_instant(self, text: str, time_s: float, db: str) -> dict:
        self._check_readable()
        steps = np.array([time_s])
        expr = pp.parse(text)
        with self._tracked(text, db):
            frame = self._eval(expr, steps, db)
        if frame.is_scalar:
            return {"resultType": "scalar", "result": [time_s, _fmt(frame.values[0, 0])]}
        with _stage("render"):
            result = []
            for i, labels in enumerate(frame.labels):
                if frame.valid[i, 0]:
                    result.append(
                        {"metric": labels, "value": [float(time_s), _fmt(frame.values[i, 0])]}
                    )
            # top-level sort()/sort_desc()/sort_by_label() own the output
            # order; everything else gets the stable by-labels order
            if not (isinstance(expr, pp.FunctionCall)
                    and expr.name in ("sort", "sort_desc", "sort_by_label",
                                      "sort_by_label_desc")):
                result.sort(key=lambda r: sorted(r["metric"].items()))
        return {"resultType": "vector", "result": result}

    def series_labels(self, vs: "pp.VectorSelector", db: str) -> list[dict]:
        """Label sets of series matching a selector — INDEX-ONLY, no data
        decode (the /api/v1/series metadata surface). Unlike the query
        path, ALL __name__ matcher operators are honored (=, !=, =~, !~)
        by filtering the measurement set."""
        self._check_readable()
        shards = self.engine.shards_for_range(db, None, -(2**62), 2**62)
        metrics: set[str] | None = {vs.metric} if vs.metric else None
        for m in vs.matchers:
            if m.name != "__name__":
                continue
            if metrics is None:
                metrics = {n for sh in shards for n in sh.index.measurements()}
            try:
                if m.op == "=":
                    metrics &= {m.value}
                elif m.op == "!=":
                    metrics -= {m.value}
                elif m.op in ("=~", "!~"):
                    rx = re.compile(_anchor(m.value))
                    hit = {n for n in metrics if rx.search(n)}
                    metrics = hit if m.op == "=~" else metrics - hit
            except re.error as e:
                raise PromError(f"invalid __name__ regex: {e}") from None
        if metrics is None:
            raise PromError("metric name required")
        seen = set()
        out = []
        for sh in shards:
            for metric in sorted(metrics):
                for sid in _match_sids(sh, metric, vs.matchers,
                                       self.device):
                    tags = sh.index.tags_of(sid)
                    key = (metric, tuple(sorted(tags.items())))
                    if key not in seen:
                        seen.add(key)
                        labels = dict(tags)
                        labels["__name__"] = metric
                        out.append(labels)
        return out

    def _check_readable(self) -> None:
        if getattr(self.engine, "read_disabled", False):
            raise PromError("reads are disabled (syscontrol)")

    @contextmanager
    def _tracked(self, text: str, db: str):
        """Register the PromQL evaluation with the running-query registry
        (shows in /debug/queries with per-stage attribution, KILL QUERY
        cancels it between shard scans) and note it in the slow-query
        log. On a rank of a mesh across processes the evaluation holds
        the process's mesh lock (parallel/runtime.py mesh_program)."""
        from opengemini_tpu_torch.parallel import runtime

        t0 = _time.perf_counter_ns()
        qid = TRACKER.register(text, db)
        try:
            with runtime.mesh_program():
                yield
        finally:
            dur_ns = _time.perf_counter_ns() - t0
            if SLOWLOG.enabled():
                SLOWLOG.note(qid, text, db, dur_ns / 1e6,
                             stages=TRACKER.stages_of(qid),
                             extra={"kind": "promql"})
            TRACKER.unregister(qid)

    # -- evaluation -------------------------------------------------------

    def _eval(self, node, steps: np.ndarray, db: str) -> Frame:
        k = len(steps)
        if isinstance(node, pp.NumberLit):
            return Frame.scalar(node.val, k)
        if isinstance(node, pp.VectorSelector):
            return self._eval_selector(node, steps, db, self.lookback_s, instant=True)
        if isinstance(node, (pp.MatrixSelector, pp.Subquery)):
            raise PromError("range vector must be wrapped in a function (e.g. rate)")
        if isinstance(node, pp.FunctionCall):
            return self._eval_function(node, steps, db)
        if isinstance(node, pp.Aggregation):
            return self._eval_aggregation(node, steps, db)
        if isinstance(node, pp.BinaryOp):
            return self._eval_binop(node, steps, db)
        raise PromError(f"unsupported expression {type(node).__name__}")

    def _collect_series(self, vs: pp.VectorSelector, t_min_ns: int,
                        t_max_ns: int, db: str, want_encoded: bool = False):
        """-> run-encoded (labels list, t_ms_all, v_all, lens[, enc]):
        one concatenated (times, values) pair with per-series lengths,
        ready for prepare_matrix_runs' flat scatter / the tiled prepare —
        no per-series matrix fill loop downstream.

        ``want_encoded=True`` (the traced tiled path with device decode
        active) additionally tries to keep the value column in its
        on-disk encoded blocks: when the whole match resolves to
        untrimmed all-valid slices of ONE still-encoded bulk column, the
        5th return is (ftype, blocks, segments, slices) and v_all is None — the
        device decodes (ops/device_decode.decode_rows_matrix); any
        cross-shard merge, partial validity, or decoded column falls
        back to returning the values eagerly, exactly as before."""
        metric = self._metric_of(vs)
        shards = self.engine.shards_for_range(db, None, t_min_ns, t_max_ns)
        # series may span shards: merge by label key.
        # per_key: key -> (tags, [(times_ms, values)])
        per_key: dict[tuple, tuple] = {}

        def add(tags: dict, t_ms: np.ndarray, vals: np.ndarray) -> None:
            key = tuple(sorted(tags.items()))
            got = per_key.get(key)
            if got is None:
                per_key[key] = (tags, [(t_ms, vals)])
            else:
                got[1].append((t_ms, vals))

        vf = self.value_field
        bulk_min = _bulk_sids_min()
        for sh in shards:
            TRACKER.check()  # KILL QUERY cancellation point per shard
            sids = _match_sids(sh, metric, vs.matchers, self.device)
            if sids.size == 0:
                continue
            if sids.size >= bulk_min and hasattr(sh, "read_series_bulk"):
                # batched multi-series decode: packed (colstore) chunks
                # decode once for every matched series.  Default for ANY
                # match size (OGT_PROM_BULK_SIDS=1); raise the knob to
                # make the per-sid decode loop handle small matches.
                # _match_sids already hands the sorted int64 array — no
                # tags_of label materialization on the match path
                sid_arr, rec = sh.read_series_bulk(
                    metric, sids, t_min_ns, t_max_ns, fields=[vf])
                col = rec.columns.get(vf)
                if col is None or len(rec) == 0:
                    continue
                times_ms = rec.times // MS
                # keep a still-encoded column encoded: per-series slices
                # become (col, lo, hi) markers resolved at assembly; any
                # partial-validity slice decodes the whole column (lazy
                # .values — the bit-identical host path)
                enc_col = (col if want_encoded
                           and getattr(col, "is_decoded", True) is False
                           else None)
                vals64 = (None if enc_col is not None
                          else col.values.astype(np.float64))
                uniq, starts = np.unique(sid_arr, return_index=True)
                ends = np.append(starts[1:], len(sid_arr))
                if hasattr(sh.index, "entries_bulk"):
                    entries = sh.index.entries_bulk(uniq)
                else:
                    entries = [(None, tuple(sh.index.tags_of(int(s)).items()))
                               for s in uniq]
                for (sid, lo, hi), entry in zip(
                        zip(uniq, starts, ends), entries):
                    if entry is None:
                        continue
                    m = col.valid[lo:hi]
                    if not m.any():
                        continue
                    if enc_col is not None and m.all():
                        add(dict(entry[1]), times_ms[lo:hi],
                            _EncSlice(enc_col, int(lo), int(hi)))
                        continue
                    if vals64 is None:
                        vals64 = col.values.astype(np.float64)
                    add(dict(entry[1]), times_ms[lo:hi][m],
                        vals64[lo:hi][m])
            else:
                for sid in sids.tolist():
                    rec = sh.read_series(metric, sid, t_min_ns, t_max_ns,
                                         fields=[vf])
                    col = rec.columns.get(vf)
                    if col is None or len(rec) == 0:
                        continue
                    valid = col.valid
                    if not valid.any():
                        continue
                    add(sh.index.tags_of(sid),
                        rec.times[valid] // MS,
                        col.values[valid].astype(np.float64))
        out_labels: list[dict] = []
        t_parts: list[np.ndarray] = []
        v_parts: list = []
        lens: list[int] = []
        for key in sorted(per_key):
            tags, parts = per_key[key]
            if len(parts) == 1:
                t, v = parts[0]
            else:
                t = np.concatenate([p[0] for p in parts])
                v = np.concatenate([_materialize_slice(p[1])
                                    for p in parts])
                order = np.argsort(t, kind="stable")
                t, v = t[order], v[order]
            labels = dict(tags)
            labels["__name__"] = metric
            out_labels.append(labels)
            t_parts.append(t)
            v_parts.append(v)
            lens.append(len(t))
        t_ms_all = (np.concatenate(t_parts) if t_parts
                    else np.empty(0, np.int64)).astype(np.int64, copy=False)
        enc = None
        if want_encoded and v_parts:
            enc = _assemble_enc(v_parts)
        if enc is not None:
            v_all = None
        else:
            v_all = (np.concatenate(
                [_materialize_slice(v) for v in v_parts]) if v_parts
                else np.empty(0, np.float64))
        if want_encoded:
            return (out_labels, t_ms_all, v_all,
                    np.asarray(lens, np.int64), enc)
        return out_labels, t_ms_all, v_all, np.asarray(lens, np.int64)

    def _eval_selector(self, vs, steps, db, window_s, instant):
        eval_times = steps - vs.offset_s
        t_max_ns = int(eval_times[-1] * 1e9) + 1
        t_min_ns = int((eval_times[0] - window_s) * 1e9)
        with _stage("prom_collect"):
            labels, t_ms_all, v_all, lens = self._collect_series(
                vs, t_min_ns, t_max_ns, db)
        k = len(steps)
        if not labels:
            return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
        with _stage("prom_prepare"):
            times, values, counts, base_ms = promops.prepare_matrix_runs(
                t_ms_all, v_all, lens, dtype=np.float64)
            dense = promops.to_device(times, values, counts, self.device)
        rel = eval_times - base_ms / 1000.0
        with _stage("prom_kernel"):
            vals, valid = promops.instant_values(*dense, rel, window_s)
            vals, valid = devobs.fetch_np(vals), devobs.fetch_np(valid)
        return Frame(labels, vals, valid)

    def _eval_function(self, node: pp.FunctionCall, steps, db) -> Frame:
        name = node.name
        range_fns = {
            "rate": (True, True), "increase": (True, False), "delta": (False, False),
        }
        if name in range_fns:
            is_counter, is_rate = range_fns[name]
            ms_sel = _expect_matrix(node, 0)
            return self._eval_range_fn(
                ms_sel, steps, db,
                {"kind": "rate", "is_counter": is_counter, "is_rate": is_rate})
        if name in ("changes", "resets"):
            ms_sel = _expect_matrix(node, 0)
            return self._eval_range_fn(
                ms_sel, steps, db, {"kind": "changes_resets", "which": name})
        if name == "absent":
            if not node.args:
                raise PromError("absent() requires an argument")
            f = self._eval(node.args[0], steps, db)
            k = len(steps)
            present = f.valid.any(axis=0) if len(f.labels) else np.zeros(k, bool)
            # prometheus derives the output labels from the selector's
            # equality matchers (promql/functions.go createLabelsForAbsent)
            labels = {}
            arg = node.args[0]
            if isinstance(arg, pp.VectorSelector):
                for m in arg.matchers:
                    if m.op == "=" and m.name != "__name__":
                        labels[m.name] = m.value
            return Frame([labels], np.ones((1, k)), ~present[None, :])
        if name == "histogram_quantile":
            if len(node.args) != 2:
                raise PromError("histogram_quantile(q, vector) takes 2 arguments")
            q = _expect_number(node, 0)
            f = self._eval(node.args[1], steps, db)
            return _histogram_quantile(q, f, len(steps))
        if name in ("irate", "idelta"):
            ms_sel = _expect_matrix(node, 0)
            return self._eval_range_fn(
                ms_sel, steps, db,
                {"kind": "instant_rate", "per_second": name == "irate"})
        if name == "quantile_over_time":
            q = _expect_number(node, 0)
            ms_sel = _expect_matrix(node, 1)
            return self._eval_range_fn(
                ms_sel, steps, db, {"kind": "quantile", "q": q})
        if name == "mad_over_time":
            ms_sel = _expect_matrix(node, 0)
            return self._eval_range_fn(ms_sel, steps, db, {"kind": "mad"})
        if name == "absent_over_time":
            ms_sel = _expect_matrix(node, 0)
            f = self._eval_range_fn(
                ms_sel, steps, db, {"kind": "over_time", "func": "present"})
            k = len(steps)
            present = f.valid.any(axis=0) if len(f.labels) else np.zeros(k, bool)
            labels = {}
            vec = getattr(ms_sel, "vector", None)
            if vec is not None:
                for m in vec.matchers:
                    if m.op == "=" and m.name != "__name__":
                        labels[m.name] = m.value
            return Frame([labels], np.ones((1, k)), ~present[None, :])
        if name.endswith("_over_time"):
            func = name[: -len("_over_time")]
            ms_sel = _expect_matrix(node, 0)
            return self._eval_range_fn(
                ms_sel, steps, db, {"kind": "over_time", "func": func})
        if name == "deriv":
            ms_sel = _expect_matrix(node, 0)
            return self._eval_range_fn(ms_sel, steps, db, {"kind": "deriv"})
        if name == "predict_linear":
            ms_sel = _expect_matrix(node, 0)
            dur = _expect_number(node, 1)
            return self._eval_range_fn(
                ms_sel, steps, db, {"kind": "predict", "dur": dur})
        if name in ("holt_winters", "double_exponential_smoothing"):
            ms_sel = _expect_matrix(node, 0)
            sf = _expect_number(node, 1)
            tf = _expect_number(node, 2)
            if not (0 < sf < 1 and 0 < tf < 1):
                raise PromError(
                    "holt_winters smoothing factors must be in (0, 1)"
                )
            return self._eval_range_fn(
                ms_sel, steps, db, {"kind": "holt", "sf": sf, "tf": tf})
        if name == "scalar":
            f = self._eval(node.args[0], steps, db)
            if len(f.labels) == 1:
                # steps where the series had no sample become NaN (prom)
                vals = np.where(f.valid[:1], f.values[:1], np.nan)
                return Frame([{}], vals, np.ones((1, len(steps)), bool), True)
            vals = np.full((1, len(steps)), np.nan)
            return Frame([{}], vals, np.ones_like(vals, dtype=bool), True)
        if name == "vector":
            f = self._eval(node.args[0], steps, db)
            f.is_scalar = False
            return f
        # elementwise math (prom promql/functions.go simple call table)
        elem = {
            "abs": np.abs, "ceil": np.ceil, "floor": np.floor, "exp": np.exp,
            "ln": np.log, "log2": np.log2, "log10": np.log10, "sqrt": np.sqrt,
            "round": np.round, "sgn": np.sign,
            "sin": np.sin, "cos": np.cos, "tan": np.tan,
            "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
            "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
            "asinh": np.arcsinh, "acosh": np.arccosh, "atanh": np.arctanh,
            "deg": np.degrees, "rad": np.radians,
        }
        if name in elem:
            f = self._eval(node.args[0], steps, db)
            with np.errstate(all="ignore"):
                f.values = elem[name](f.values)
            f.labels = [_drop_name(l) for l in f.labels]
            return f
        if name in ("clamp_min", "clamp_max"):
            f = self._eval(node.args[0], steps, db)
            bound = _expect_number(node, 1)
            f.values = (
                np.maximum(f.values, bound) if name == "clamp_min"
                else np.minimum(f.values, bound)
            )
            f.labels = [_drop_name(l) for l in f.labels]
            return f
        if name == "clamp":
            f = self._eval(node.args[0], steps, db)
            lo = _expect_number(node, 1)
            hi = _expect_number(node, 2)
            if lo > hi:
                # prom: clamp with min > max returns an empty vector
                k = len(steps)
                return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
            f.values = np.clip(f.values, lo, hi)
            f.labels = [_drop_name(l) for l in f.labels]
            return f
        if name == "timestamp":
            f = self._eval(node.args[0], steps, db)
            f.values = np.broadcast_to(steps[None, :], f.values.shape).copy()
            f.labels = [_drop_name(l) for l in f.labels]
            return f
        if name == "pi":
            return Frame.scalar(math.pi, len(steps))
        if name == "time":
            k = len(steps)
            return Frame([{}], steps[None, :].astype(float).copy(),
                         np.ones((1, k), bool), True)
        if name in _CLOCK_FNS:
            # clock functions take an optional vector defaulting to time()
            if node.args:
                f = self._eval(node.args[0], steps, db)
                f.labels = [_drop_name(l) for l in f.labels]
            else:
                f = Frame([{}], steps[None, :].astype(float).copy(),
                          np.ones((1, len(steps)), bool), True)
            f.values = _CLOCK_FNS[name](f.values)
            return f
        if name == "label_replace":
            return self._label_replace(node, steps, db)
        if name == "label_join":
            return self._label_join(node, steps, db)
        if name in ("sort", "sort_desc"):
            f = self._eval(node.args[0], steps, db)
            if len(f.labels) > 1:
                # order by the (last) evaluated value; range queries sort
                # by series labels at output regardless (prom ignores sort
                # for range queries)
                key = np.where(f.valid[:, -1], f.values[:, -1], -np.inf)
                order = np.argsort(-key if name == "sort_desc" else key,
                                   kind="stable")
                f.labels = [f.labels[i] for i in order]
                f.values = f.values[order]
                f.valid = f.valid[order]
            return f
        if name in ("sort_by_label", "sort_by_label_desc"):
            f = self._eval(node.args[0], steps, db)
            keys = [_expect_string(node, i) for i in range(1, len(node.args))]
            if not keys:
                raise PromError(f"{name}() expects at least one label")
            order = sorted(
                range(len(f.labels)),
                key=lambda i: tuple(f.labels[i].get(k, "") for k in keys),
                reverse=name.endswith("_desc"),
            )
            f.labels = [f.labels[i] for i in order]
            f.values = f.values[order]
            f.valid = f.valid[order]
            return f
        raise PromError(f"unsupported function {name!r}")

    def _label_replace(self, node, steps, db) -> Frame:
        """label_replace(v, dst, replacement, src, regex) — prom
        funcLabelReplace: fully-anchored regex against src; on match, dst
        is set to the expanded replacement ($1 group refs)."""
        if len(node.args) != 5:
            raise PromError("label_replace takes 5 arguments")
        f = self._eval(node.args[0], steps, db)
        dst = _expect_string(node, 1)
        repl = _expect_string(node, 2)
        src = _expect_string(node, 3)
        pattern = _expect_string(node, 4)
        if not _LABEL_NAME_RE.match(dst):
            raise PromError(f"invalid destination label name {dst!r}")
        try:
            rx = re.compile("^(?:" + pattern + ")$")
        except re.error as e:
            raise PromError(f"invalid regex in label_replace: {e}") from None
        out_labels = []
        for labels in f.labels:
            val = labels.get(src, "")
            m = rx.match(val)
            if m is None:
                out_labels.append(labels)
                continue
            new = dict(labels)
            expanded = _go_expand(repl, m)
            if expanded:
                new[dst] = expanded
            else:
                new.pop(dst, None)
            out_labels.append(new)
        f.labels = out_labels
        return f

    def _label_join(self, node, steps, db) -> Frame:
        """label_join(v, dst, sep, src...) — prom funcLabelJoin."""
        if len(node.args) < 3:
            raise PromError("label_join takes at least 3 arguments")
        f = self._eval(node.args[0], steps, db)
        dst = _expect_string(node, 1)
        sep = _expect_string(node, 2)
        srcs = [_expect_string(node, i) for i in range(3, len(node.args))]
        if not _LABEL_NAME_RE.match(dst):
            raise PromError(f"invalid destination label name {dst!r}")
        out_labels = []
        for labels in f.labels:
            joined = sep.join(labels.get(s, "") for s in srcs)
            new = dict(labels)
            if joined:
                new[dst] = joined
            else:
                new.pop(dst, None)
            out_labels.append(new)
        f.labels = out_labels
        return f

    # default subquery resolution when [range:] omits the step (the
    # Prometheus global evaluation interval analogue)
    subquery_default_step_s = 60.0

    def _subquery_samples(self, sq: "pp.Subquery", steps, db):
        """Evaluate the inner expression on an absolutely-aligned step
        grid covering the outer window -> run-encoded
        (labels, t_ms_all, v_all, lens) shaped like _collect_series."""
        # explicit None check: `or` would silently turn [range:0s] into
        # the default step instead of rejecting it
        step = self.subquery_default_step_s if sq.step_s is None else sq.step_s
        if step <= 0:
            raise PromError("subquery step must be positive")
        t_end = float(steps[-1]) - sq.offset_s
        t_start = float(steps[0]) - sq.offset_s - sq.range_s
        first = math.ceil(t_start / step) * step  # absolute alignment
        n = int(math.floor((t_end - first) / step)) + 1
        empty = ([], np.empty(0, np.int64), np.empty(0, np.float64),
                 np.empty(0, np.int64))
        if n <= 0:
            return empty
        if n > 11_000:
            raise PromError("subquery produces too many steps (max 11000)")
        sub_steps = first + np.arange(n) * step
        inner = self._eval(sq.expr, sub_steps, db)
        if inner.is_scalar:
            raise PromError("subquery is only allowed on instant vector")
        # rint, not truncation: x.2999999*1000 would land 1ms early and
        # flip boundary inclusion in the (start, end] kernel windows
        times_ms = np.rint(sub_steps * 1000.0).astype(np.int64)
        labels, t_parts, v_parts, lens = [], [], [], []
        for i in range(len(inner.labels)):
            mask = inner.valid[i]
            if not mask.any():
                continue
            labels.append(inner.labels[i])
            t_parts.append(times_ms[mask])
            v_parts.append(np.asarray(inner.values[i][mask], np.float64))
            lens.append(int(mask.sum()))
        if not labels:
            return empty
        return (labels, np.concatenate(t_parts), np.concatenate(v_parts),
                np.asarray(lens, np.int64))

    # range-function kinds the tiled engine lowers; everything else
    # (quantile/mad/holt_winters — no prefix form) keeps the chunked
    # dense fallback
    _TILED_KINDS = frozenset(
        ["rate", "instant_rate", "changes_resets", "deriv", "predict"])
    _TILED_OVER_TIME = frozenset(
        ["sum", "avg", "count", "last", "present", "stddev", "stdvar",
         "min", "max"])

    def _eval_range_fn(self, ms_sel, steps, db, spec: dict) -> Frame:
        if isinstance(ms_sel, pp.Subquery):
            w = ms_sel.range_s
            eval_times = steps - ms_sel.offset_s
            labels, t_ms_all, v_all, lens = self._subquery_samples(
                ms_sel, steps, db)
            enc = None
        else:
            vs = ms_sel.vector
            w = ms_sel.range_s
            eval_times = steps - vs.offset_s
            t_max_ns = int(eval_times[-1] * 1e9) + 1
            t_min_ns = int((eval_times[0] - w) * 1e9)
            with _stage("prom_collect"):
                got = self._collect_series(
                    vs, t_min_ns, t_max_ns, db,
                    want_encoded=_want_encoded(self.device))
                labels, t_ms_all, v_all, lens = got[:4]
                enc = got[4] if len(got) > 4 else None
        k = len(steps)
        if not labels:
            return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
        out, valid = self._run_range_kernel(
            spec, t_ms_all, v_all, lens, eval_times, float(w), enc=enc)
        labels = [_drop_name(l) for l in labels]
        return Frame(labels, out, valid)

    def _tiled_prep(self, spec, t_ms_all, v_all, lens, eval_times, w,
                    enc=None):
        """TiledPrepared for this (samples, window grid) pair, or None
        when the spec or the grid is ineligible (dense fallback)."""
        kind = spec["kind"]
        if kind not in self._TILED_KINDS and not (
                kind == "over_time" and spec["func"] in self._TILED_OVER_TIME):
            return None
        if not _tiled_enabled():
            return None
        n_max = int(lens.max())
        s_dim = len(lens)
        cells = _tile_cells_mult()
        max_tiles = min(max(cells * n_max + 64, 1024),
                        max((1 << 28) // max(s_dim, 1), 64))
        plan = promops.plan_tiles(
            eval_times - w, eval_times, int(t_ms_all.min()),
            int(t_ms_all.max()), max_tiles)
        if plan is None:
            return None
        return promops.prepare_tiled(
            plan, t_ms_all, v_all, lens, dtype=np.float64,
            max_gather_cols=cells * n_max + 64, enc=enc, device=self.device)

    def _run_tiled_kernel(self, spec, kind, prep, host: bool):
        """Single-device tiled kernels: host numpy or torch on the
        engine's device per the planner's route."""
        STATS.incr("prom", "tiled_kernels")
        xp = np if host else torch
        with _stage("prom_kernel"):
            if kind == "rate":
                out, valid = prep.rate(
                    xp, is_counter=spec["is_counter"],
                    is_rate=spec["is_rate"])
            elif kind == "instant_rate":
                out, valid = prep.instant_rate(
                    xp, per_second=spec["per_second"])
            elif kind == "changes_resets":
                out, valid = prep.changes_resets(xp, kind=spec["which"])
            elif kind == "deriv":
                out, _icept, valid = prep.linear_regression(xp)
            elif kind == "predict":
                slope, icept, valid = prep.linear_regression(xp)
                out = icept + slope * spec["dur"]
            else:
                out, valid = prep.over_time(xp, func=spec["func"])
            kr = prep.k_real
            return (devobs.fetch_np(out)[:, :kr],
                    devobs.fetch_np(valid)[:, :kr])

    def _run_mesh_kernel(self, spec, kind, prep, mesh):
        """Multi-shard tiled kernels: the series axis split over the
        mesh, each kernel run on every shard; results sliced back to the
        real (S, k) window grid on the host."""
        STATS.incr("prom", "tiled_mesh_kernels")
        # the sharding transfer counts in the prepare stage (it builds
        # this query's device state)
        with _stage("prom_prepare"):
            sharded = prep.sharded(mesh)
        with _stage("prom_kernel"):
            if kind == "rate":
                out, valid = sharded.rate(
                    is_counter=spec["is_counter"],
                    is_rate=spec["is_rate"])
            elif kind == "instant_rate":
                out, valid = sharded.instant_rate(
                    per_second=spec["per_second"])
            elif kind == "changes_resets":
                out, valid = sharded.changes_resets(kind=spec["which"])
            elif kind == "deriv":
                out, _icept, valid = sharded.linear_regression()
            elif kind == "predict":
                slope, icept, valid = sharded.linear_regression()
                out = icept + slope * spec["dur"]
            else:
                out, valid = sharded.over_time(func=spec["func"])
            kr = prep.k_real
            return (devobs.fetch_np(out)[:prep.S, :kr],
                    devobs.fetch_np(valid)[:prep.S, :kr])

    def _run_range_kernel(self, spec, t_ms_all, v_all, lens, eval_times,
                          w, enc=None):
        """Dispatch one range-vector spec: tiled interval reductions when
        the window grid fits the ms tile lattice, dense kernels otherwise.
        Returns host numpy (out, valid)."""
        kind = spec["kind"]
        with _stage("prom_prepare"):
            prep = self._tiled_prep(spec, t_ms_all, v_all, lens,
                                    eval_times, w, enc=enc)
        if prep is None and v_all is None:
            # the dense kernels need host values: materialize the
            # encoded descriptor (bit-identical host decode)
            from opengemini_tpu_torch.ops import device_decode

            v_all = device_decode.materialize_enc(enc)
        mesh = _mesh_for_tiled() if prep is not None else None
        if prep is not None:
            # route through the offload planner (query/offload.py): the
            # static prior is the mesh when one is configured, else host
            # numpy per _host_kernels(), and the OGT_PROM_HOST_KERNELS
            # override prunes the candidate set, so the pin and the
            # planner are ONE mechanism
            from opengemini_tpu_torch.query import offload

            geo = (prep.S, prep.N, prep.k_real)
            mode = offload.prom_host_kernels_mode()
            candidates = [c for c in ("host", "device")
                          if not (mode == "1" and c == "device")
                          and not (mode == "0" and c == "host")]
            if mesh is not None:
                candidates.append("mesh")
            static = ("mesh" if mesh is not None
                      else "host" if _host_kernels(self.device)
                      else "device")
            route = offload.GLOBAL.decide(
                "prom_" + kind, geo, tuple(candidates), static,
                stage="prom_kernel")
            t_route = _time.perf_counter()
            if route == "mesh":
                out, valid = self._run_mesh_kernel(spec, kind, prep, mesh)
            else:
                out, valid = self._run_tiled_kernel(
                    spec, kind, prep, host=(route == "host"))
            offload.GLOBAL.observe("prom_" + kind, geo, route,
                                   _time.perf_counter() - t_route)
            return out, valid
        # dense kernels (searchsorted window bounds) on the device
        STATS.incr("prom", "dense_kernels")
        with _stage("prom_prepare"):
            times, values, counts, base_ms = promops.prepare_matrix_runs(
                t_ms_all, v_all, lens, dtype=np.float64)
            times, values, counts = promops.to_device(times, values, counts,
                                                      self.device)
        ends = eval_times - base_ms / 1000.0
        starts = ends - w
        with _stage("prom_kernel"):
            if kind == "rate":
                out, valid = promops.extrapolated_rate(
                    times, values, counts, starts, ends, w,
                    spec["is_counter"], spec["is_rate"])
            elif kind == "instant_rate":
                out, valid = promops.instant_rate(
                    times, values, counts, starts, ends, spec["per_second"])
            elif kind == "changes_resets":
                out, valid = promops.changes_resets(
                    times, values, counts, starts, ends, spec["which"])
            elif kind == "deriv":
                out, _icept, valid = promops.linear_regression(
                    times, values, counts, starts, ends)
            elif kind == "predict":
                slope, icept, valid = promops.linear_regression(
                    times, values, counts, starts, ends)
                out = icept + slope * spec["dur"]
            elif kind == "quantile":
                out, valid = promops.quantile_over_time(
                    times, values, counts, starts, ends, spec["q"])
            elif kind == "mad":
                out, valid = promops.mad_over_time(
                    times, values, counts, starts, ends)
            elif kind == "holt":
                out, valid = promops.holt_winters_window(
                    times, values, counts, starts, ends, spec["sf"],
                    spec["tf"])
            else:
                out, valid = promops.over_time(
                    times, values, counts, starts, ends, spec["func"])
            return devobs.fetch_np(out), devobs.fetch_np(valid)

    def _metric_of(self, vs: pp.VectorSelector) -> str:
        metric = vs.metric
        for m in vs.matchers:
            if m.name == "__name__":
                if m.op != "=":
                    raise PromError("__name__ supports only '=' here")
                metric = m.value
        if not metric:
            raise PromError("metric name required")
        return metric

    def _collect_runs(self, vs, t_min_ns: int, t_max_ns: int, db: str):
        """Label-free bulk collection for the lazy aggregation fast path:
        (shard, metric, uniq_sids, t_ms_all, v_all, lens) or None when
        ineligible (multi-shard ranges must merge series by label, small
        matches gain nothing)."""
        metric = self._metric_of(vs)
        shards = self.engine.shards_for_range(db, None, t_min_ns, t_max_ns)
        if (len(shards) != 1
                or not hasattr(shards[0], "read_series_bulk")
                or not hasattr(shards[0].index, "entries_bulk")):
            return None  # dict-index fallback has no bulk label fetch
        sh = shards[0]
        sids = _match_sids(sh, metric, vs.matchers, self.device)
        if sids.size < 4096:
            return None  # eager path is fine at low cardinality
        sid_arr, rec = sh.read_series_bulk(
            metric, sids, t_min_ns, t_max_ns,
            fields=[self.value_field])
        col = rec.columns.get(self.value_field)
        if col is None or len(rec) == 0:
            return (sh, metric, np.empty(0, np.int64),
                    np.empty(0, np.int64), np.empty(0, np.float64),
                    np.empty(0, np.int64))
        keep = col.valid
        sid_k = sid_arr[keep]
        uniq, lens = np.unique(sid_k, return_counts=True)
        return (sh, metric, uniq, rec.times[keep] // MS,
                col.values[keep].astype(np.float64), lens)

    def _eval_agg_fast(self, node: pp.Aggregation, steps, db):
        """topk/bottomk/count_values over a bare high-cardinality selector
        without materializing input labels: the winners' (or none of the)
        labels resolve AFTER selection. At 1M series the eager path spends
        ~85% of its time building label dicts that the result never uses
        (BASELINE.md config #5). Returns None when inapplicable.

        Exact-value ties at the topk/bottomk boundary may admit a
        different (equally-valid) subset than the eager path: this path
        scans rows in sid order, the eager path in label order, and
        Prometheus defines boundary ties as arbitrary."""
        if (node.op not in ("topk", "bottomk", "count_values")
                or node.grouping or node.without
                or not isinstance(node.expr, pp.VectorSelector)):
            return None
        vs = node.expr
        window_s = self.lookback_s
        eval_times = steps - vs.offset_s
        t_max_ns = int(eval_times[-1] * 1e9) + 1
        t_min_ns = int((eval_times[0] - window_s) * 1e9)
        got = self._collect_runs(vs, t_min_ns, t_max_ns, db)
        if got is None:
            return None
        sh, metric, uniq, t_ms_all, v_all, lens = got
        k = len(steps)
        if len(uniq) == 0:
            return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
        times, values, counts, base_ms = promops.prepare_matrix_runs(
            t_ms_all, v_all, lens, dtype=np.float64)
        rel = eval_times - base_ms / 1000.0
        vals, valid = promops.instant_values(
            *promops.to_device(times, values, counts, self.device), rel,
            window_s)
        vals, valid = devobs.fetch_np(vals), devobs.fetch_np(valid)

        def resolve(rows):
            entries = sh.index.entries_bulk(uniq[rows])
            out = []
            for e in entries:
                lbl = dict(e[1]) if e is not None else {}
                lbl["__name__"] = metric
                out.append(lbl)
            return out

        if node.op in ("topk", "bottomk"):
            nv = _expect_number_node(node.param)
            if math.isnan(nv) or math.isinf(nv):
                raise PromError(f"invalid {node.op} parameter: {_fmt(nv)}")
            n = int(nv)
            if n <= 0:
                return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
            keep = _topk_keep(vals, valid, min(n, len(uniq)),
                              descending=(node.op == "topk"))
            rows = np.flatnonzero(keep.any(axis=1))
            labels = resolve(rows)
            order = sorted(range(len(rows)),
                           key=lambda i: tuple(sorted(labels[i].items())))
            rows = rows[order]
            return Frame([labels[i] for i in order], vals[rows], keep[rows])

        # count_values: input labels are never consulted (no grouping)
        if not isinstance(node.param, pp.StringLit):
            raise PromError("count_values expects a label-name string")
        out_labels, out_rows = _count_values_cells(
            vals, valid, k, {}, node.param.val)
        if not out_labels:
            return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
        out = np.vstack(out_rows)
        return Frame(out_labels, out, out > 0)

    def _eval_aggregation(self, node: pp.Aggregation, steps, db) -> Frame:
        fast = self._eval_agg_fast(node, steps, db)
        if fast is not None:
            return fast
        f = self._eval(node.expr, steps, db)
        k = len(steps)
        if not f.labels:
            return f
        # group key per series
        keys = []
        out_labels_by_key: dict[tuple, dict] = {}
        for labels in f.labels:
            l = _drop_name(labels)
            if node.without:
                grp = {n: v for n, v in l.items() if n not in node.grouping}
            elif node.grouping:
                grp = {n: v for n, v in l.items() if n in node.grouping}
            else:
                grp = {}
            key = tuple(sorted(grp.items()))
            keys.append(key)
            out_labels_by_key[key] = grp
        uniq = sorted(out_labels_by_key)
        key_idx = {kk: i for i, kk in enumerate(uniq)}
        g = len(uniq)
        vals = np.where(f.valid, f.values, 0.0)
        member = np.zeros((g, len(f.labels)), dtype=bool)
        for si, kk in enumerate(keys):
            member[key_idx[kk], si] = True
        counts = member.astype(np.float64) @ f.valid.astype(np.float64)
        any_valid = counts > 0

        op = node.op
        if op in ("sum", "avg", "count", "stddev", "stdvar", "group"):
            s = member.astype(np.float64) @ vals
            if op == "sum":
                out = s
            elif op == "count":
                out = counts
            elif op == "group":
                out = np.ones_like(s)
            else:
                mean = s / np.maximum(counts, 1)
                sq = member.astype(np.float64) @ np.where(f.valid, f.values**2, 0.0)
                var = sq / np.maximum(counts, 1) - mean**2
                var = np.maximum(var, 0)
                if op == "avg":
                    out = mean
                elif op == "stdvar":
                    out = var
                else:
                    out = np.sqrt(var)
            if op == "avg":
                out = s / np.maximum(counts, 1)
            return Frame([dict(u) for u in (out_labels_by_key[kk] for kk in uniq)],
                         out, any_valid)
        if op in ("min", "max"):
            fill = np.inf if op == "min" else -np.inf
            masked = np.where(f.valid, f.values, fill)
            out = np.full((g, k), fill)
            for si, kk in enumerate(keys):
                gi = key_idx[kk]
                out[gi] = np.minimum(out[gi], masked[si]) if op == "min" else np.maximum(out[gi], masked[si])
            return Frame([dict(u) for u in (out_labels_by_key[kk] for kk in uniq)],
                         out, any_valid)
        if op in ("topk", "bottomk"):
            nv = _expect_number_node(node.param)
            if math.isnan(nv) or math.isinf(nv):
                raise PromError(f"invalid {op} parameter: {_fmt(nv)}")
            n = int(nv)
            keep = np.zeros_like(f.valid)
            if n > 0:
                for gi in range(g):
                    rows = np.flatnonzero(member[gi])
                    keep[rows] = _topk_keep(
                        f.values[rows], f.valid[rows],
                        min(n, len(rows)), descending=(op == "topk"),
                    )
            return Frame(f.labels, f.values, keep)
        if op == "quantile":
            # vectorized Prom quantile: sort once per group, linear
            # interpolation at rank q*(n_valid-1) per step column
            q = float(_expect_number_node(node.param))
            out = np.full((g, k), np.nan)
            if math.isnan(q):  # Prom: NaN phi -> NaN for every group
                return Frame([dict(u) for u in (out_labels_by_key[kk] for kk in uniq)],
                             out, any_valid)
            for gi in range(g):
                rows = np.flatnonzero(member[gi])
                sub_valid = f.valid[rows]
                nvalid = sub_valid.sum(axis=0)  # (K,)
                has = nvalid > 0
                if q < 0 or q > 1:
                    out[gi] = np.where(has, -np.inf if q < 0 else np.inf,
                                       np.nan)
                    continue
                srt = np.sort(np.where(sub_valid, f.values[rows], np.inf),
                              axis=0)
                rank = q * np.maximum(nvalid - 1, 0)
                lo = np.floor(rank).astype(np.int64)
                hi = np.minimum(lo + 1, np.maximum(nvalid - 1, 0))
                w = rank - lo
                cols = np.arange(k)
                cap = len(rows) - 1
                vlo = srt[np.minimum(lo, cap), cols]
                vhi = srt[np.minimum(hi, cap), cols]
                res = np.where(has, vlo * (1 - w) + vhi * w, np.nan)
                # a valid NaN sample poisons its column's quantile (the
                # +Inf padding above would otherwise sort before it and
                # fabricate +Inf where Prometheus interpolates to NaN)
                nan_col = (sub_valid & np.isnan(f.values[rows])).any(axis=0)
                out[gi] = np.where(nan_col, np.nan, res)
            return Frame([dict(u) for u in (out_labels_by_key[kk] for kk in uniq)],
                         out, any_valid)
        if op == "count_values":
            if not isinstance(node.param, pp.StringLit):
                raise PromError("count_values expects a label-name string")
            label = node.param.val
            out_labels, out_rows = [], []
            for gi, kk in enumerate(uniq):
                rows = np.flatnonzero(member[gi])
                lbls, rws = _count_values_cells(
                    f.values[rows], f.valid[rows], k,
                    out_labels_by_key[kk], label)
                out_labels.extend(lbls)
                out_rows.extend(rws)
            if not out_labels:
                return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
            counts_m = np.stack(out_rows)
            return Frame(out_labels, counts_m, counts_m > 0)
        raise PromError(f"unsupported aggregation {op!r}")

    def _eval_binop(self, node: pp.BinaryOp, steps, db) -> Frame:
        lhs = self._eval(node.lhs, steps, db)
        rhs = self._eval(node.rhs, steps, db)
        op = node.op
        k = len(steps)
        if op in pp.SET_OPS:
            if lhs.is_scalar or rhs.is_scalar:
                raise PromError(
                    f"set operator {op!r} not allowed in binary scalar "
                    "expression")
            return _eval_set_op(op, lhs, rhs, node.matching, k)
        if lhs.is_scalar and rhs.is_scalar:
            if op in pp.COMPARISONS:
                # Prometheus: "comparisons between scalars must use BOOL"
                if not node.bool_mod:
                    raise PromError(
                        "comparisons between scalars must use BOOL modifier")
                v = _cmp(op, lhs.values, rhs.values).astype(np.float64)
                return Frame([{}], v, lhs.valid & rhs.valid, True)
            v = _apply_op(op, lhs.values, rhs.values, comparison_keep=False)
            return Frame([{}], v, lhs.valid & rhs.valid, True)
        if lhs.is_scalar or rhs.is_scalar:
            vec, sc, flipped = (rhs, lhs, True) if lhs.is_scalar else (lhs, rhs, False)
            a, b = (sc.values, vec.values) if flipped else (vec.values, sc.values)
            if op in pp.COMPARISONS:
                m = _cmp(op, a, b)
                if node.bool_mod:
                    labels = [_drop_name(l) for l in vec.labels]
                    vals = np.where(m, 1.0, 0.0)
                    return Frame(labels,
                                 np.broadcast_to(vals, vec.values.shape).copy(),
                                 vec.valid.copy())
                return Frame(vec.labels, vec.values, vec.valid & m)
            v = _apply_op(op, a, b, comparison_keep=False)
            labels = [_drop_name(l) for l in vec.labels]
            return Frame(labels, np.broadcast_to(v, vec.values.shape).copy(), vec.valid)
        return _eval_vector_binop(op, lhs, rhs, node.matching,
                                  node.bool_mod, k)


def _signature(labels: dict, matching: "pp.VectorMatching | None") -> tuple:
    """Match signature of a series under on()/ignoring() (Prometheus
    signatureFunc): on() hashes exactly the named labels (absent = ""),
    ignoring() hashes everything else minus __name__."""
    base = _drop_name(labels)
    if matching is not None and matching.on:
        return tuple(base.get(n, "") for n in sorted(set(matching.labels)))
    ignored = set(matching.labels) if matching is not None else ()
    return tuple(sorted((n, v) for n, v in base.items() if n not in ignored))


def _eval_set_op(op: str, lhs: Frame, rhs: Frame,
                 matching, k: int) -> Frame:
    """and/or/unless (VectorAnd/VectorOr/VectorUnless): set membership by
    match signature, applied per step via the validity masks."""
    rsig_valid: dict[tuple, np.ndarray] = {}
    for j, rl in enumerate(rhs.labels):
        s = _signature(rl, matching)
        got = rsig_valid.get(s)
        rsig_valid[s] = rhs.valid[j] if got is None else (got | rhs.valid[j])
    if op == "or":
        lsig_valid: dict[tuple, np.ndarray] = {}
        for i, ll in enumerate(lhs.labels):
            s = _signature(ll, matching)
            got = lsig_valid.get(s)
            lsig_valid[s] = lhs.valid[i] if got is None else (got | lhs.valid[i])
        labels = list(lhs.labels)
        vals = [lhs.values[i] for i in range(len(lhs.labels))]
        valid = [lhs.valid[i] for i in range(len(lhs.labels))]
        for j, rl in enumerate(rhs.labels):
            s = _signature(rl, matching)
            lv = lsig_valid.get(s)
            v = rhs.valid[j] if lv is None else (rhs.valid[j] & ~lv)
            if v.any():
                labels.append(rl)
                vals.append(rhs.values[j])
                valid.append(v)
        if not labels:
            return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
        return Frame(labels, np.stack(vals), np.stack(valid))
    # and / unless keep lhs rows, gated by rhs presence at the step
    labels, vals, valid = [], [], []
    zero = np.zeros(k, bool)
    for i, ll in enumerate(lhs.labels):
        rv = rsig_valid.get(_signature(ll, matching), zero)
        v = (lhs.valid[i] & rv) if op == "and" else (lhs.valid[i] & ~rv)
        if v.any():
            labels.append(ll)
            vals.append(lhs.values[i])
            valid.append(v)
    if not labels:
        return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
    return Frame(labels, np.stack(vals), np.stack(valid))


_DROP_NAME_OPS = {"+", "-", "*", "/", "%", "^", "atan2"}


def _result_metric(many_labels: dict, one_labels: dict, op: str,
                   matching, bool_mod: bool) -> dict:
    """Prometheus resultMetric (promql/engine.go): output labels start
    from the many side; one-to-one restricts by on/ignoring; group
    modifiers graft include labels from the one side."""
    out = dict(many_labels)
    if op in _DROP_NAME_OPS or bool_mod:
        out.pop("__name__", None)
    if matching.card == "one-to-one":
        if matching.on:
            keep = set(matching.labels)
            out = {n: v for n, v in out.items() if n in keep}
        else:
            for n in matching.labels:
                out.pop(n, None)
    for n in matching.include:
        v = one_labels.get(n, "")
        if v != "":
            out[n] = v
        else:
            out.pop(n, None)
    return out


def _eval_vector_binop(op: str, lhs: Frame, rhs: Frame, matching,
                       bool_mod: bool, k: int) -> Frame:
    """Vector/vector arithmetic and comparison with full matching
    semantics (Prometheus VectorBinop; reference transpiler surface:
    promql2influxql/binary_expr.go:308)."""
    if matching is None:
        matching = pp.VectorMatching(False, [], "one-to-one")
    # orient so `one` is the side that must have unique signatures
    if matching.card == "one-to-many":  # group_right: lhs is the one side
        many, one, swapped = rhs, lhs, True
    else:
        many, one, swapped = lhs, rhs, False
    # index the one side; equal signatures are an error when both series
    # are present at any step, else the disjoint rows merge
    one_rows: dict[tuple, tuple[np.ndarray, np.ndarray, dict]] = {}
    for j, ol in enumerate(one.labels):
        s = _signature(ol, matching)
        got = one_rows.get(s)
        if got is None:
            one_rows[s] = (one.values[j], one.valid[j], ol)
            continue
        gv, gval, glabels = got
        if (gval & one.valid[j]).any():
            side = "right" if not swapped else "left"
            raise PromError(
                "found duplicate series for the match group on the "
                f"{side} hand-side of the operation; many-to-many "
                "matching not allowed: matching labels must be unique "
                "on one side")
        if matching.include and any(
                glabels.get(n) != one.labels[j].get(n)
                for n in matching.include):
            raise PromError(
                "found series with conflicting group_left/group_right "
                "include labels in the match group")
        one_rows[s] = (
            np.where(one.valid[j], one.values[j], gv),
            gval | one.valid[j], glabels,
        )
    out_labels, out_vals, out_valid = [], [], []
    # result-series uniqueness: Prometheus errors when two matches land
    # on the same output labels at the same step
    seen: dict[tuple, np.ndarray] = {}
    for i, ml in enumerate(many.labels):
        got = one_rows.get(_signature(ml, matching))
        if got is None:
            continue
        ov, oval, olabels = got
        both = many.valid[i] & oval
        vl, vr = (many.values[i], ov) if not swapped else (ov, many.values[i])
        if op in pp.COMPARISONS:
            m = _cmp(op, vl, vr)
            if bool_mod:
                vals = np.where(m, 1.0, 0.0)
                valid = both
            else:
                vals = vl
                valid = both & m
        else:
            vals = _apply_op(op, vl, vr, comparison_keep=False)
            valid = both
        labels = _result_metric(ml, olabels, op, matching, bool_mod)
        sig = tuple(sorted(labels.items()))
        prev = seen.get(sig)
        if prev is not None:
            if (prev & valid).any():
                if matching.card == "one-to-one":
                    raise PromError(
                        "multiple matches for labels: many-to-one "
                        "matching must be explicit (group_left/"
                        "group_right)")
                raise PromError(
                    "multiple matches for labels: grouping labels must "
                    "ensure unique matches")
            seen[sig] = prev | valid
        else:
            seen[sig] = valid.copy()
        if valid.any():
            out_labels.append(labels)
            out_vals.append(np.asarray(vals, np.float64))
            out_valid.append(valid)
    if not out_labels:
        return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
    return Frame(out_labels, np.stack(out_vals), np.stack(out_valid))


def _histogram_quantile(q: float, f: Frame, k: int) -> Frame:
    """Prom histogram_quantile over `le`-bucketed series
    (promql/quantile.go bucketQuantile): group by labels minus `le`,
    sort buckets, interpolate within the winning bucket. Vectorized over
    steps per group (one (B, K) matrix pass, no per-column python loops).

    Prom edge semantics: q > 1 -> +Inf, q < 0 -> -Inf; a winning FIRST
    bucket with upperBound <= 0 returns that bound (interpolation starts
    at 0 only for positive first buckets); a winning +Inf bucket returns
    the previous bound."""
    groups: dict[tuple, list[tuple[float, int]]] = {}
    labels_of: dict[tuple, dict] = {}
    for i, labels in enumerate(f.labels):
        le = labels.get("le")
        if le is None:
            continue
        le_v = float("inf") if le in ("+Inf", "inf", "Inf") else float(le)
        rest = {kk: v for kk, v in labels.items() if kk not in ("le", "__name__")}
        key = tuple(sorted(rest.items()))
        groups.setdefault(key, []).append((le_v, i))
        labels_of[key] = rest
    out_labels, out_vals, out_valid = [], [], []
    for key in sorted(groups):
        buckets = sorted(groups[key])
        les = np.array([le for le, _i in buckets])  # (B,), ascending
        rows = [i for _le, i in buckets]
        if len(buckets) < 2 or not math.isinf(les[-1]):
            continue
        counts = f.values[rows]  # (B, K) cumulative by le
        bvalid = f.valid[rows]
        valid = bvalid.all(axis=0)  # all buckets present at the step
        total = counts[-1]
        valid &= total > 0
        if q > 1 or q < 0:
            vals = np.full(k, np.inf if q > 1 else -np.inf)
            out_labels.append(labels_of[key])
            out_vals.append(vals)
            out_valid.append(valid)
            continue
        rank = q * total  # (K,)
        # first bucket index with count >= rank
        hit = counts >= rank[None, :]
        win = np.argmax(hit, axis=0)  # (K,)
        prev = np.clip(win - 1, 0, len(buckets) - 1)
        prev_c = np.where(win > 0, counts[prev, np.arange(k)], 0.0)
        prev_le = np.where(win > 0, les[prev], 0.0)
        win_le = les[win]
        win_c = counts[win, np.arange(k)]
        span = win_c - prev_c
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = np.where(span > 0, (rank - prev_c) / np.where(span == 0, 1, span), 1.0)
            vals = prev_le + (win_le - prev_le) * frac
        # +Inf winning bucket -> previous bound (second-highest le)
        vals = np.where(np.isinf(win_le), les[-2] if len(les) >= 2 else 0.0, vals)
        # first bucket with non-positive bound -> the bound itself
        vals = np.where((win == 0) & (win_le <= 0), win_le, vals)
        out_labels.append(labels_of[key])
        out_vals.append(vals)
        out_valid.append(valid)
    if not out_labels:
        return Frame([], np.zeros((0, k)), np.zeros((0, k), bool))
    return Frame(out_labels, np.stack(out_vals), np.stack(out_valid))


def _count_values_cells(sub, sub_valid, k: int, base_labels: dict,
                        label: str):
    """Shared count_values bucketing (eager grouped path + lazy fast
    path): one pass over valid cells — unique codes + bincount,
    O(cells + distinct x steps) — plus the NaN bucket. Returns
    (labels, rows)."""
    cell_cols = np.broadcast_to(np.arange(k), sub.shape)[sub_valid]
    seen = sub[sub_valid]
    out_labels, out_rows = [], []
    if not len(seen):
        return out_labels, out_rows
    nanmask = np.isnan(seen)
    vals_f, cols_f = seen[~nanmask], cell_cols[~nanmask]
    uvals, inv = np.unique(vals_f, return_inverse=True)
    counts = np.bincount(
        inv * k + cols_f, minlength=len(uvals) * k
    ).reshape(len(uvals), k).astype(np.float64)
    for ui, v in enumerate(uvals):
        lbl = dict(base_labels)
        lbl[label] = _fmt(float(v))
        out_labels.append(lbl)
        out_rows.append(counts[ui])
    if nanmask.any():
        lbl = dict(base_labels)
        lbl[label] = "NaN"
        out_labels.append(lbl)
        out_rows.append(
            np.bincount(cell_cols[nanmask], minlength=k).astype(np.float64))
    return out_labels, out_rows


def _topk_keep(values: np.ndarray, valid: np.ndarray, m: int,
               descending: bool) -> np.ndarray:
    """(R, K) keep-mask of the m largest (descending) / smallest VALID
    entries per column. Exact f64 comparisons, O(R x K) via partition
    (full argsort of a 1M-series group would pay R log R per column);
    invalid cells never rank; valid NaN cells rank below every comparable
    value but still fill leftover room (Prometheus pushes NaN samples
    while the heap has room); boundary ties resolve to the lowest row
    index, deterministically."""
    if m <= 0:
        return np.zeros_like(valid)
    keyx = np.where(valid, -values if descending else values, np.nan)
    R = keyx.shape[0]
    if m >= R:
        return valid.copy()
    part = np.partition(keyx, m - 1, axis=0)  # NaN sorts last
    b = part[m - 1]  # per-column boundary (m-th best), NaN if < m usable
    strict = keyx < b
    ties = keyx == b
    need = m - strict.sum(axis=0)
    tie_rank = np.cumsum(ties, axis=0) - 1
    keep = strict | (ties & (tie_rank < need))
    short = np.isnan(b)  # fewer than m comparable cells in the column
    if short.any():
        keep[:, short] = valid[:, short] & ~np.isnan(values[:, short])
    # leftover room (columns with < m comparable cells) fills with valid
    # NaN samples in row order, matching the Prometheus heap
    room = m - keep.sum(axis=0)
    if (room > 0).any():
        nanv = valid & np.isnan(values)
        nan_rank = np.cumsum(nanv, axis=0) - 1
        keep |= nanv & (nan_rank < room)
    return keep


def _prom_quantile(q: float, vals: list[float]) -> float:
    if not vals:
        return float("nan")
    if q < 0:
        return float("-inf")
    if q > 1:
        return float("inf")
    s = sorted(vals)
    n = len(s)
    rank = q * (n - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, n - 1)
    w = rank - lo
    return s[lo] * (1 - w) + s[hi] * w


def _apply_op(op, a, b, comparison_keep):
    with np.errstate(all="ignore"):
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return np.where(b != 0, a / np.where(b == 0, 1, b), np.inf * np.sign(a))
        if op == "%":
            return np.mod(a, np.where(b == 0, np.nan, b))
        if op == "^":
            return np.power(a, b)
        if op == "atan2":
            return np.arctan2(a, b)
    raise PromError(f"unsupported operator {op!r}")


def _cmp(op, a, b):
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    return a >= b


def _drop_name(labels: dict) -> dict:
    return {k: v for k, v in labels.items() if k != "__name__"}


def _expect_matrix(node, i):
    if i >= len(node.args) or not isinstance(
            node.args[i], (pp.MatrixSelector, pp.Subquery)):
        raise PromError(f"{node.name}() expects a range vector")
    return node.args[i]


def _const_fold(e):
    """Constant expression value or None (unary minus parses as -1 * x)."""
    if isinstance(e, pp.NumberLit):
        return e.val
    if isinstance(e, pp.BinaryOp):
        lv, rv = _const_fold(e.lhs), _const_fold(e.rhs)
        if lv is None or rv is None:
            return None
        return float(_apply_op(e.op, np.float64(lv), np.float64(rv),
                               comparison_keep=False))
    return None


def _expect_number(node, i) -> float:
    v = _const_fold(node.args[i]) if i < len(node.args) else None
    if v is None:
        raise PromError(f"{node.name}() expects a number argument")
    return v


def _expect_number_node(n) -> float:
    v = _const_fold(n) if n is not None else None
    if v is None:
        raise PromError("expected a number parameter")
    return v


def _expect_string(node, i) -> str:
    arg = node.args[i] if i < len(node.args) else None
    if not isinstance(arg, pp.StringLit):
        raise PromError(f"{node.name}() expects a string argument at position {i}")
    return arg.val


_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

_GO_REF_RE = re.compile(r"\$(?:\{(\w+)\}|(\w+))")


def _go_expand(template: str, m: re.Match) -> str:
    """Go Regexp.Expand semantics for label_replace replacements: $1 /
    ${name} group refs, a missing or out-of-range group expands to ""
    (never an error), no backslash escape processing."""

    def sub(ref: re.Match) -> str:
        name = ref.group(1) or ref.group(2)
        try:
            got = m.group(int(name)) if name.isdigit() else m.group(name)
        except (IndexError, re.error):
            return ""
        return got or ""

    return _GO_REF_RE.sub(sub, template)


def _clock_days(t: np.ndarray) -> np.ndarray:
    safe = np.where(np.isfinite(t), t, 0.0)
    return np.floor(safe).astype("int64").astype("datetime64[s]").astype("datetime64[D]")


def _clock(fn):
    def wrapped(t: np.ndarray) -> np.ndarray:
        with np.errstate(all="ignore"):
            return fn(t).astype(float)

    return wrapped


# prom clock functions (UTC; promql/functions.go funcHour et al.)
_CLOCK_FNS = {
    "minute": _clock(lambda t: np.floor(t / 60) % 60),
    "hour": _clock(lambda t: np.floor(t / 3600) % 24),
    "day_of_week": _clock(lambda t: (np.floor(t / 86400) + 4) % 7),
    "day_of_month": _clock(
        lambda t: (_clock_days(t) - _clock_days(t).astype("datetime64[M]")
                   ).astype(int) + 1
    ),
    "day_of_year": _clock(
        lambda t: (_clock_days(t) - _clock_days(t).astype("datetime64[Y]")
                   ).astype(int) + 1
    ),
    "days_in_month": _clock(
        lambda t: (
            (_clock_days(t).astype("datetime64[M]") + 1).astype("datetime64[D]")
            - _clock_days(t).astype("datetime64[M]").astype("datetime64[D]")
        ).astype(int)
    ),
    "month": _clock(
        lambda t: _clock_days(t).astype("datetime64[M]").astype(int) % 12 + 1
    ),
    "year": _clock(
        lambda t: _clock_days(t).astype("datetime64[Y]").astype(int) + 1970
    ),
}


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))
