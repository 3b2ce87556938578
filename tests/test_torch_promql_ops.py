"""The port's PromQL range-vector kernels (ops/prom.py) against the JAX
package's, on the CPU, over the same seeded ragged series.

- Every dense kernel: torch on CPU tensors against jax.numpy on the CPU
  (x64). Tolerance: rel 1e-9 with an absolute floor of 1e-9 times the
  data's scale (prefix sums and the regression's cancellations add in
  another order), exact for gathers, counts, validity and min/max.
- Every TiledPrepared method on both routes: the host route (numpy)
  against the reference's numpy route, exactly; the device route (torch
  on the CPU) against the reference's jax.numpy route, at the tolerance
  above.
- The edge cases: empty windows, one-sample series, windows before the
  first and after the last sample, samples on a window's open and closed
  edge, a reset pair straddling a window start, NaN and +-Inf values.
- decode_rows_matrix on the CPU against the JAX package's and against
  materialize_enc (the host decode), bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengemini_tpu.ops import device_decode as jdd
from opengemini_tpu.ops import prom as jprom
from opengemini_tpu.record import FieldType as JFieldType
from opengemini_tpu.storage import encoding as jenc
from opengemini_tpu_torch.ops import device_decode as tdd
from opengemini_tpu_torch.ops import prom as tprom
from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.storage import encoding as tenc
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

BASE_MS = 1_700_000_000_000
RTOL = 1e-9


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _close(got, want, exact=False, scale=1.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact or got.dtype == np.bool_:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               equal_nan=True)


def gen_series(rng, S, max_n=90, special=False):
    """Ragged irregular series (run-encoded): counters with resets,
    empty and one-sample series, optional NaN/+-Inf values."""
    t_parts, v_parts, lens = [], [], []
    for i in range(S):
        n = int(rng.integers(0, max_n + 1))
        if i == 0:
            n = 0
        elif i == 1:
            n = 1
        t = BASE_MS + np.cumsum(rng.integers(1_000, 30_001, n)).astype(
            np.int64)
        if i == 2 and n > 3:  # samples exactly on the 15 s lattice
            t = BASE_MS + 15_000 * np.arange(1, n + 1, dtype=np.int64)
        inc = rng.exponential(50.0, n)
        v = np.cumsum(inc)
        resets = rng.random(n) < 0.06
        for j in np.flatnonzero(resets):
            v[j:] -= v[j] - rng.random() * 5
        if special and n:
            v[rng.random(n) < 0.04] = np.nan
            v[rng.random(n) < 0.02] = np.inf
            v[rng.random(n) < 0.02] = -np.inf
        t_parts.append(t)
        v_parts.append(v)
        lens.append(n)
    return (np.concatenate(t_parts), np.concatenate(v_parts),
            np.asarray(lens, np.int64))


def window_grid(step_s=45.0, w_s=120.0, k=40, start_off_s=-200.0):
    """Window ends (seconds, absolute) from before the first sample to
    past the last."""
    ends = BASE_MS / 1000.0 + start_off_s + step_s * np.arange(k)
    return ends - w_s, ends, w_s


def _dense_inputs(t_all, v_all, lens):
    times, values, counts, base_ms = jprom.prepare_matrix_runs(
        t_all, v_all, lens, dtype=np.float64)
    tt = tprom.prepare_matrix_runs(t_all, v_all, lens, dtype=np.float64)
    for a, b in zip(tt[:3], (times, values, counts)):
        np.testing.assert_array_equal(a, b)
    assert tt[3] == base_ms
    dev = tprom.to_device(times, values, counts, "cpu")
    return (times, values, counts, base_ms), dev


@pytest.fixture(params=[False, True], ids=["finite", "nan_inf"])
def data(request):
    rng = np.random.default_rng(7 if request.param else 3)
    return gen_series(rng, 18, special=request.param)


# -- dense kernels ---------------------------------------------------------------


@pytest.mark.parametrize("grid", [(45.0, 120.0, 40, -200.0),
                                  (7.0, 7.0, 60, 5.0),
                                  (300.0, 600.0, 12, -900.0)])
def test_window_bounds_and_instant_values(data, grid):
    (times, values, counts, base), dev = _dense_inputs(*data)
    starts, ends, _w = window_grid(*grid)
    rs, re_ = starts - base / 1000.0, ends - base / 1000.0
    for got, want in zip(tprom.window_bounds(dev[0], dev[2], rs, re_),
                         jprom.window_bounds(times, counts, rs, re_)):
        _close(got, want, exact=True)
    for lookback in (300.0, 20.0):
        got = tprom.instant_values(*dev, re_, lookback)
        want = jprom.instant_values(times, values, counts, re_, lookback)
        _close(got[1], want[1], exact=True)
        _close(got[0], want[0], exact=True)


@pytest.mark.parametrize("is_counter,is_rate", [(True, True), (True, False),
                                                (False, False)])
def test_extrapolated_rate(data, is_counter, is_rate):
    (times, values, counts, base), dev = _dense_inputs(*data)
    starts, ends, w = window_grid()
    rs, re_ = starts - base / 1000.0, ends - base / 1000.0
    got = tprom.extrapolated_rate(*dev, rs, re_, w, is_counter, is_rate)
    want = jprom.extrapolated_rate(times, values, counts, rs, re_, w,
                                   is_counter, is_rate)
    _close(got[1], want[1])
    v = np.where(_np(want[1]), _np(want[0]), 0)
    _close(np.where(_np(got[1]), _np(got[0]), 0), v, scale=1e4)


def test_reset_corrections(data):
    (times, values, counts, _b), dev = _dense_inputs(*data)
    _close(tprom.reset_corrections(dev[1], dev[2]),
           jprom.reset_corrections(values, counts), scale=1e4)


@pytest.mark.parametrize("func", ["sum", "avg", "count", "last", "stddev",
                                  "stdvar", "present", "min", "max"])
def test_over_time(data, func):
    (times, values, counts, base), dev = _dense_inputs(*data)
    starts, ends, _w = window_grid()
    rs, re_ = starts - base / 1000.0, ends - base / 1000.0
    got = tprom.over_time(*dev, rs, re_, func)
    want = jprom.over_time(times, values, counts, rs, re_, func)
    _close(got[1], want[1])
    if func == "stddev":
        # the square root of a variance that cancels to ~0 carries the
        # variance's rounding (~1e-16 of the squared scale) as ~1e-8 of
        # the scale, absolute
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=RTOL,
                                   atol=1e-7 * 1e4, equal_nan=True)
        return
    _close(got[0], want[0], exact=func in ("count", "last", "present",
                                           "min", "max"), scale=1e4)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.99, 1.0, -0.5, 1.5])
def test_quantile_over_time(data, q):
    (times, values, counts, base), dev = _dense_inputs(*data)
    starts, ends, _w = window_grid()
    rs, re_ = starts - base / 1000.0, ends - base / 1000.0
    got = tprom.quantile_over_time(*dev, rs, re_, q)
    want = jprom.quantile_over_time(times, values, counts, rs, re_, q)
    _close(got[1], want[1])
    _close(got[0], want[0], scale=1e4)


def test_mad_and_linear_regression_and_holt(data):
    (times, values, counts, base), dev = _dense_inputs(*data)
    starts, ends, _w = window_grid()
    rs, re_ = starts - base / 1000.0, ends - base / 1000.0
    got = tprom.mad_over_time(*dev, rs, re_)
    want = jprom.mad_over_time(times, values, counts, rs, re_)
    _close(got[1], want[1])
    _close(got[0], want[0], scale=1e4)
    got = tprom.linear_regression(*dev, rs, re_)
    want = jprom.linear_regression(times, values, counts, rs, re_)
    _close(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        m = _np(want[2])
        _close(np.where(m, _np(g), 0), np.where(m, _np(w), 0), scale=1e5)
    got = tprom.holt_winters_window(*dev, rs, re_, 0.3, 0.6)
    want = jprom.holt_winters_window(times, values, counts, rs, re_,
                                     0.3, 0.6)
    _close(got[1], want[1])
    m = _np(want[1])
    # the scan's order of operations is kept: rel 1e-12
    np.testing.assert_allclose(np.where(m, _np(got[0]), 0),
                               np.where(m, _np(want[0]), 0), rtol=1e-12,
                               atol=1e-12 * 1e4, equal_nan=True)


@pytest.mark.parametrize("kind", ["changes", "resets"])
@pytest.mark.parametrize("per_second", [True, False])
def test_changes_resets_and_instant_rate(data, kind, per_second):
    (times, values, counts, base), dev = _dense_inputs(*data)
    starts, ends, _w = window_grid()
    rs, re_ = starts - base / 1000.0, ends - base / 1000.0
    got = tprom.changes_resets(*dev, rs, re_, kind)
    want = jprom.changes_resets(times, values, counts, rs, re_, kind)
    _close(got[1], want[1])
    _close(got[0], want[0], exact=True)
    got = tprom.instant_rate(*dev, rs, re_, per_second)
    want = jprom.instant_rate(times, values, counts, rs, re_, per_second)
    _close(got[1], want[1])
    m = _np(want[1])
    _close(np.where(m, _np(got[0]), 0), np.where(m, _np(want[0]), 0))


# -- the tiled engine --------------------------------------------------------------


def _preps(t_all, v_all, lens, starts, ends):
    jp = jprom.plan_tiles(starts, ends, int(t_all.min()), int(t_all.max()),
                          1 << 20)
    tp = tprom.plan_tiles(starts, ends, int(t_all.min()), int(t_all.max()),
                          1 << 20)
    assert jp is not None and tp is not None
    for name in jprom.TilePlan.__slots__:
        a, b = getattr(tp, name), getattr(jp, name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, name
    jprep = jprom.TiledPrepared(jp, t_all, v_all, lens, dtype=np.float64,
                                max_gather_cols=1 << 20)
    tprep = tprom.TiledPrepared(tp, t_all, v_all, lens, dtype=np.float64,
                                max_gather_cols=1 << 20, device="cpu")
    return jprep, tprep


def _kernel_cases():
    return [
        ("rate", dict(is_counter=True, is_rate=True)),
        ("rate", dict(is_counter=True, is_rate=False)),
        ("rate", dict(is_counter=False, is_rate=False)),
        ("instant_rate", dict(per_second=True)),
        ("instant_rate", dict(per_second=False)),
        ("changes_resets", dict(kind="changes")),
        ("changes_resets", dict(kind="resets")),
        ("linear_regression", {}),
        *[("over_time", dict(func=f)) for f in
          ("sum", "avg", "count", "last", "present", "stddev", "stdvar",
           "min", "max")],
    ]


@pytest.mark.parametrize("method,kw", _kernel_cases(),
                         ids=lambda x: str(x))
@pytest.mark.parametrize("grid", [(45.0, 120.0, 40, -200.0),
                                  (60.0, 60.0, 30, 0.0),
                                  (15.0, 300.0, 50, 17.0)])
def test_tiled_both_routes(data, method, kw, grid):
    t_all, v_all, lens = data
    starts, ends, _w = window_grid(*grid)
    jprep, tprep = _preps(t_all, v_all, lens, starts, ends)
    exact_vals = method in ("changes_resets",) or kw.get("func") in (
        "count", "last", "present", "min", "max")
    # host route: the reference's own numpy code path, bit for bit
    got = getattr(tprep, method)(np, **kw)
    want = getattr(jprep, method)(np, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # device route: torch on CPU tensors against jax.numpy
    got = getattr(tprep, method)(torch, **kw)
    want = getattr(jprep, method)(jnp, **kw)
    valid_w = _np(want[-1])
    _close(got[-1], valid_w)
    for g, w in zip(got[:-1], want[:-1]):
        g = np.where(valid_w, _np(g), 0)
        w = np.where(valid_w, _np(w), 0)
        _close(g, w, exact=exact_vals, scale=1e5)


def _one(t_s_list, v_list, starts, ends):
    t = np.asarray([BASE_MS + int(round(s * 1000)) for s in t_s_list],
                   np.int64)
    v = np.asarray(v_list, np.float64)
    lens = np.asarray([len(t)], np.int64)
    starts = BASE_MS / 1000.0 + np.asarray(starts, np.float64)
    ends = BASE_MS / 1000.0 + np.asarray(ends, np.float64)
    return _preps(t, v, lens, starts, ends)


@pytest.mark.parametrize("t_s,v,starts,ends", [
    # a sample on a window's open start edge is excluded, on its closed
    # end edge included
    ([10, 20, 30], [1, 2, 3], [10, 0], [30, 20]),
    # an empty window between samples, one before and one after all
    ([10, 20, 100, 110], [1, 2, 3, 4], [30, -50, 200], [60, -20, 230]),
    # one sample only
    ([50], [7.0], [0, 40], [60, 100]),
    # a reset pair straddling a window start
    ([10, 20, 30, 40], [5, 9, 1, 4], [25, 5], [45, 25]),
    # NaN and +-Inf values
    ([10, 20, 30, 40, 50], [1, np.nan, np.inf, -np.inf, 2], [0, 25, 15],
     [60, 45, 35]),
])
def test_tiled_edges(t_s, v, starts, ends):
    starts, ends = np.asarray(starts, float), np.asarray(ends, float)
    w = ends - starts
    order = np.argsort(ends)
    # the tile plan needs one window width: run each width alone
    for width in np.unique(w):
        sel = order[w[order] == width]
        jprep, tprep = _one(t_s, v, starts[sel], ends[sel])
        for method, kw in _kernel_cases():
            got = getattr(tprep, method)(np, **kw)
            want = getattr(jprep, method)(np, **kw)
            for g, ww in zip(got, want):
                np.testing.assert_array_equal(g, ww)
            got = getattr(tprep, method)(torch, **kw)
            want = getattr(jprep, method)(jnp, **kw)
            m = _np(want[-1])
            _close(got[-1], m)
            for g, ww in zip(got[:-1], want[:-1]):
                _close(np.where(m, _np(g), 0), np.where(m, _np(ww), 0),
                       scale=10.0)


def test_plan_ineligible_like_the_reference():
    base = BASE_MS / 1000.0
    # sub-ms edges
    assert tprom.plan_tiles([base + 0.0005], [base + 1.0005], BASE_MS,
                            BASE_MS + 1, 1024) is None
    assert jprom.plan_tiles([base + 0.0005], [base + 1.0005], BASE_MS,
                            BASE_MS + 1, 1024) is None
    # over the tile cap
    starts = base + np.arange(100) * 1.0
    assert tprom.plan_tiles(starts, starts + 0.5, BASE_MS, BASE_MS + 1,
                            10) is None
    # the gather budget: both answer None from prepare_tiled
    t = BASE_MS + np.arange(500, dtype=np.int64)
    v = np.arange(500, dtype=np.float64)
    lens = np.array([500], np.int64)
    ends = np.array([base + 0.5])
    plan = tprom.plan_tiles(ends - 0.5, ends, int(t.min()), int(t.max()),
                            1 << 20)
    assert tprom.prepare_tiled(plan, t, v, lens, max_gather_cols=1) is None


def test_namespaces():
    assert tprom.namespace(np) is tprom.HOST
    xp = tprom.namespace(torch, "cpu")
    assert isinstance(xp, tprom.TorchXP) and xp.device.type == "cpu"
    with pytest.raises(ValueError):
        tprom.namespace(torch)
    a = torch.tensor([[1.0, 5.0, 2.0]], dtype=torch.float64)
    idx = torch.tensor([[7, -3]])
    # out-of-range indices clamp into the row (never a device assert)
    assert xp.take_along_axis(a, idx, 1).tolist() == [[2.0, 1.0]]


# -- the encoded value matrix ----------------------------------------------------


def _blocks(rng, n_blocks=3, n=700):
    """Gorilla-profile float blocks, in both packages' encoders."""
    bufs = []
    for b in range(n_blocks):
        v = np.floor(np.cumsum(rng.normal(0, 3, n))) + 100 * b
        v[::97] = np.nan
        bt, bj = tenc.encode_floats(v), jenc.encode_floats(v)
        assert bt == bj
        bufs.append(bt)
    return bufs


@pytest.mark.parametrize("segments", [None, "trim"])
def test_decode_rows_matrix_bit_for_bit(monkeypatch, segments):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(11)
    blocks = _blocks(rng)
    kinds = {tenc.device_block(b).kind for b in blocks}
    assert kinds == {"gorilla"}, kinds
    n_full = 3 * 700
    segs = None
    n_view = n_full
    if segments == "trim":
        segs = np.array([[5, 690], [700, 1400], [1500, 2050]], np.int64)
        n_view = int((segs[:, 1] - segs[:, 0]).sum())
    # one long series pads the matrix: the encoded transfer then beats
    # the padded value matrix (the cost gate's rule)
    lens = rng.integers(0, 60, 9)
    lens[0] = 1300
    lens[-1] = 0
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    assert starts[-1] + lens[-1] <= n_view
    slices = tuple((int(a), int(a + n)) for a, n in zip(starts, lens))
    S, N = len(slices), int(lens.max())
    enc_t = (FieldType.FLOAT, tuple(blocks), segs, slices)
    enc_j = (JFieldType.FLOAT, tuple(blocks), segs, slices)
    host = tdd.materialize_enc(enc_t)
    np.testing.assert_array_equal(host, jdd.materialize_enc(enc_j))
    before = TSTATS.counters("device").get("decode_blocks_gorilla_total", 0)
    got = tdd.decode_rows_matrix(enc_t, (S, N), np.float64, "cpu")
    assert got is not None
    assert TSTATS.counters("device")["decode_blocks_gorilla_total"] \
        == before + 3
    want = np.asarray(jdd.decode_rows_matrix(enc_j, (S, N), np.float64))
    assert got.numpy().tobytes() == want.tobytes()
    # the rows laid from the host decode, bit for bit
    mat = np.zeros((S, N))
    off = 0  # materialize_enc concatenates the slices
    for i, (a, b) in enumerate(slices):
        mat[i, :b - a] = host[off:off + b - a]
        off += b - a
    assert got.numpy().tobytes() == mat.tobytes()
    # the site's pre-warm builder runs it once on zeros of these shapes
    from opengemini_tpu_torch.query import offload as toffload
    from opengemini_tpu_torch.utils import devobs as tdevobs

    geo = (3, n_view, (S, N))
    build = toffload._builders[("prom_decode_rows", toffload.geo_key(geo))]
    monkeypatch.setattr(tdevobs, "_ran", set())
    build()
    assert tdevobs.has_run("prom_decode_rows", geo)


def test_decode_rows_matrix_declines_like_the_reference(monkeypatch):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    blocks = _blocks(np.random.default_rng(2), n_blocks=1, n=100)
    enc = (FieldType.FLOAT, tuple(blocks), None, ((0, 50), (50, 101)))
    assert tdd.decode_rows_matrix(enc, (2, 60), np.float64, "cpu") is None
    monkeypatch.setenv("OGT_DEVICE_DECODE", "0")
    enc = (FieldType.FLOAT, tuple(blocks), None, ((0, 50), (50, 100)))
    assert tdd.decode_rows_matrix(enc, (2, 60), np.float64, "cpu") is None
    assert not tdd.active()


def test_tiled_values_decode_on_the_device_route(monkeypatch):
    """A still-encoded column: the host route materializes, the device
    route decodes the rows matrix; both answer as the eager values."""
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(4)
    blocks = _blocks(rng, n_blocks=2, n=600)
    lens = np.array([300, 250, 400, 250], np.int64)
    t_all = np.concatenate([BASE_MS + 10_000 * np.arange(1, n + 1)
                            for n in lens]).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    slices = tuple((int(a), int(a + n)) for a, n in zip(starts, lens))
    enc = (FieldType.FLOAT, tuple(blocks), None, slices)
    v_all = tdd.materialize_enc(enc)
    ends = BASE_MS / 1000.0 + 600.0 * np.arange(1, 8)
    plan = tprom.plan_tiles(ends - 600.0, ends, int(t_all.min()),
                            int(t_all.max()), 1 << 20)
    eager = tprom.TiledPrepared(plan, t_all, v_all, lens, device="cpu")
    lazy = tprom.TiledPrepared(plan, t_all, None, lens, enc=enc,
                               device="cpu")
    for method, kw in _kernel_cases():
        want = getattr(eager, method)(torch, **kw)
        got = getattr(lazy, method)(torch, **kw)
        for g, w in zip(got, want):
            assert _np(g).tobytes() == _np(w).tobytes()
    assert lazy.values is None  # the device route never built host values
    host = lazy.over_time(np, func="max")
    np.testing.assert_array_equal(host[0],
                                  eager.over_time(np, func="max")[0])
