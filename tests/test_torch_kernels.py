"""The plain versions of the port's three CUDA kernels
(opengemini_tpu_torch/ops/cuda_segment.py) against the JAX package's
Pallas kernels, run directly (interpret mode on the CPU, as
tests/test_pallas.py runs them), and against the XLA oracles
(models/ragged._stats_jit('basic' / 'selectors_xla'),
ops/segment.grid_window_agg_t).

Inputs are made with numpy from a seed: 70% mask density, fully empty
rows, integer-valued rows (value ties) and rows with few distinct times
(time ties); adversarial rows (NaN, +-inf, +-0 ties) and rows with a
large common offset. count/min/max and every selector output must
match exactly; sum/mean/ssd within rtol 1e-12 (summation order). Numpy
models of kernel 1's order of additions and of kernel 2's one-pass
merge are held to the plain versions (and kernel 1's also to the Pallas
kernel), kernel 1's within rtol 1e-10.

The kernels themselves run only on the card: test_kernels_match_plain_on_card
holds each against its plain version there and skips without CUDA.
"""

import numpy as np
import pytest
import torch

from opengemini_tpu.models import ragged as jragged
from opengemini_tpu.ops import pallas_segment as ps
from opengemini_tpu.ops import segment as jseg
from opengemini_tpu_torch.ops import cuda_segment as cs

torch.set_num_threads(1)

RTOL = 1e-12
EXACT = {"count", "min", "max", "first", "last", "sel_first", "sel_last",
         "sel_min", "sel_max"}


def _bucket(g, w, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((g, w)) * 10
    v[::2] = np.floor(v[::2])  # value ties
    m = rng.random((g, w)) < 0.7
    m[1::5] = False  # fully empty rows
    rel = rng.integers(0, 2**40, size=(g, w)).astype(np.int64)
    rel[::3] = rng.integers(0, 3, size=rel[::3].shape) << 30  # time ties
    hi = (rel >> 30).astype(np.int32)
    lo = (rel & ((1 << 30) - 1)).astype(np.int32)
    idx = rng.permutation(g * w).reshape(g, w).astype(np.int32)
    return v, hi, lo, idx, m


def _grid(s, k, w, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((s, k, w)) * 10
    v[::2] = np.floor(v[::2])
    m = rng.random((s, k, w)) < 0.7
    m[1::3] = False
    return v, m


def _np(d):
    return {k: np.asarray(x) for k, x in d.items()}


def _port(d):
    return {k: t.numpy() for k, t in d.items()}


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_same(got, want, what, rtol=RTOL):
    assert set(got) == set(want), what
    for k in want:
        a = np.asarray(got[k])
        b = np.asarray(want[k])
        assert a.shape == b.shape, (what, k)
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}.{k}")
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0,
                                       err_msg=f"{what}.{k}")


def _xla(kind):
    """The XLA oracle whatever the Pallas routing would pick."""
    fn = jragged._stats_jit("basic" if kind == "basic" else "selectors_xla")
    return fn


def _large_offset_rows(g, w, seed):
    """Values with a large common offset: even rows 1e9 + N(0, 1) (a
    counter near 1e9), odd rows 1e15 + 256 k for integers k in [0, 10)
    (an epoch-like gauge). Steps of 256 keep every partial sum of up to
    2048 values (below 2^61) exact, so the row's mean is the same bits in
    any order of addition. With steps of 1 the sum rounds (its ulp is 128
    near 1e18) and the two-pass ssd itself moves with the order far
    beyond 1e-10: the TPU kernel and the plain version then disagree by
    as much, whatever kernel 1 does."""
    rng = np.random.default_rng(seed)
    v = np.empty((g, w))
    v[0::2] = 1e9 + rng.standard_normal(v[0::2].shape)
    v[1::2] = 1e15 + 256.0 * rng.integers(0, 10, size=v[1::2].shape)
    return v


def _one_pass_ssd(v, m):
    """The one-pass sum of squares kernel 1 does not use: sum x^2 -
    (sum x)^2 / n, the shifted form at K = 0."""
    n = m.sum(axis=1)
    s = np.where(m, v, 0.0).sum(axis=1)
    return np.where(m, v * v, 0.0).sum(axis=1) - s * s / np.maximum(n, 1)


@pytest.mark.parametrize("g,w,values", [
    pytest.param(g, w, values, id=f"{g}-{w}" + ("" if values == "random"
                                                 else "-offset"))
    for values in ("random", "offset")
    for g, w in ((16, 16), (16, 64), (8, 256), (8, 1024))])
def test_bucket_basic_plain_matches_pallas_and_xla(g, w, values):
    """Also on rows with a large common offset (_large_offset_rows),
    where a one-pass sum of squares misses the tolerance on every row:
    why kernel 1 keeps the two-pass ssd around the mean."""
    v, hi, lo, idx, m = _bucket(g, w, seed=g * 7 + w)
    if values == "offset":
        v = _large_offset_rows(g, w, seed=g + w)
    got = _port(cs.bucket_stats_basic(*_t(v, m)))
    _assert_same(got, _np(ps.bucket_stats_basic(v, hi, lo, idx, m)), "pallas")
    _assert_same(got, _np(_xla("basic")(v, hi, lo, idx, m)), "xla")
    if values == "offset":
        rows = m.sum(axis=1) >= 2
        miss = np.abs(_one_pass_ssd(v, m) - got["ssd"]) > 1e-6 * got["ssd"]
        assert rows.any() and miss[rows].all()


@pytest.mark.parametrize("g,w", [(16, 16), (16, 64), (8, 256), (8, 1024)])
def test_bucket_selectors_plain_matches_pallas_and_xla(g, w):
    v, hi, lo, idx, m = _bucket(g, w, seed=100 + g * 7 + w)
    got = _port(cs.bucket_stats_selectors(*_t(v, hi, lo, idx, m)))
    _assert_same(got, _np(ps.bucket_stats_selectors(v, hi, lo, idx, m)),
                 "pallas")
    _assert_same(got, _np(_xla("selectors")(v, hi, lo, idx, m)), "xla")


def test_bucket_selectors_empty_rows_pick_last_column():
    """A row without a candidate selects column W-1 (the TPU kernel's
    clip): its first/last are v[row, W-1] and its sel_* idx[row, W-1]."""
    v, hi, lo, idx, m = _bucket(8, 16, seed=3)
    m[:] = False
    got = _port(cs.bucket_stats_selectors(*_t(v, hi, lo, idx, m)))
    np.testing.assert_array_equal(got["first"], v[:, -1])
    np.testing.assert_array_equal(got["last"], v[:, -1])
    for k in ("sel_first", "sel_last", "sel_min", "sel_max"):
        np.testing.assert_array_equal(got[k], idx[:, -1])
    _assert_same(got, _np(ps.bucket_stats_selectors(v, hi, lo, idx, m)),
                 "pallas")


def test_bucket_selectors_time_tie_takes_larger_value_then_lower_column():
    v = np.zeros((8, 16))
    v[0, :4] = [1.0, 3.0, 3.0, 2.0]
    hi = np.zeros((8, 16), np.int32)
    lo = np.zeros((8, 16), np.int32)
    idx = np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
    m = np.zeros((8, 16), bool)
    m[0, :4] = True
    got = _port(cs.bucket_stats_selectors(*_t(v, hi, lo, idx, m)))
    assert got["first"][0] == 3.0 and got["sel_first"][0] == 1
    assert got["last"][0] == 3.0 and got["sel_last"][0] == 1
    _assert_same(got, _np(ps.bucket_stats_selectors(v, hi, lo, idx, m)),
                 "pallas")


def test_bucket_selectors_nan_off_the_pick_does_not_leak():
    v, hi, lo, idx, m = _bucket(8, 16, seed=5)
    v[0, 5] = np.nan
    m[0, 5] = False  # a NaN in a lane that is not a candidate
    got = _port(cs.bucket_stats_selectors(*_t(v, hi, lo, idx, m)))
    assert not np.isnan(got["first"][0]) and not np.isnan(got["last"][0])
    _assert_same(got, _np(ps.bucket_stats_selectors(v, hi, lo, idx, m)),
                 "pallas")


@pytest.mark.parametrize("s,k,w", [(8, 6, 24), (16, 12, 16), (8, 1, 512)])
def test_grid_window_plain_matches_pallas_and_xla(s, k, w):
    v, m = _grid(s, k, w, seed=s + k + w)
    got = _port(cs.grid_window_agg(*_t(v, m)))
    _assert_same(got, _np(ps.grid_window_agg_t(v, m)), "pallas")
    _assert_same(got, _np(jseg.grid_window_agg_t(v, m)), "xla")


def test_grid_window_empty_identities():
    v, m = _grid(8, 4, 16, seed=9)
    m[:] = False
    got = _port(cs.grid_window_agg(*_t(v, m)))
    assert (got["count"] == 0).all() and (got["sum"] == 0).all()
    assert (got["mean"] == 0).all()
    assert np.isposinf(got["min"]).all() and np.isneginf(got["max"]).all()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    v, hi, lo, idx, m = _bucket(8, 16, seed=11)
    gv, gm = _grid(8, 2, 16, seed=12)
    before = dict(cs.LAUNCHES)
    cs.bucket_stats_basic(*_t(v, m))
    cs.bucket_stats_selectors(*_t(v, hi, lo, idx, m))
    cs.grid_window_agg(*_t(gv, gm))
    assert cs.LAUNCHES == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    v, hi, lo, idx, m = _bucket(8, 16, seed=13)
    tv, tm = _t(v, m)
    with pytest.raises(TypeError):
        cs.bucket_stats_basic(tv, tm.to(torch.uint8))
    with pytest.raises(ValueError):
        cs.bucket_stats_basic(tv, tm[:, :8])
    with pytest.raises(ValueError):
        cs.bucket_stats_basic(tv.to("meta"), tm.to("meta"))
    with pytest.raises(ValueError):
        cs.grid_window_agg(tv, tm)  # 2-D is not a grid


# -- adversarial rows: NaN, +-inf, +-0 ties, prefix and padded masks --------


def _bucket_adversarial(g, w, seed, mask="random"):
    """_bucket rows by class r % 11: a NaN at the would-be min (1), first
    (2), last (3) and max (4); masked-in +inf (5) and -inf (6); ties of
    -0.0 and 0.0 at the min (7) and at the max (8); all +inf (9) and all
    -inf (10). mask "prefix": each row a prefix of random length (every
    fifth row empty, the next full)."""
    v, hi, lo, idx, m = _bucket(g, w, seed)
    rng = np.random.default_rng(seed + 1)
    if mask == "prefix":
        n = rng.integers(0, w + 1, size=g)
        n[::5] = 0
        n[1::5] = w
        m = np.arange(w)[None, :] < n[:, None]
    key = hi.astype(np.int64) * (1 << 30) + lo
    big = np.iinfo(np.int64).max
    at = {1: np.where(m, v, np.inf).argmin(1),
          2: np.where(m, key, big).argmin(1),
          3: np.where(m, key, -big).argmax(1),
          4: np.where(m, v, -np.inf).argmax(1)}
    r = rng.random((g, w))
    for row in range(g):
        c = row % 11
        if c in at:
            v[row, at[c][row]] = np.nan
        elif c in (5, 6):
            v[row] = np.where(r[row] < 0.1, np.inf if c == 5 else -np.inf,
                              v[row])
        elif c in (7, 8):
            zeros = np.where(r[row] < 0.15, -0.0, 0.0)
            sign = 1.0 if c == 7 else -1.0
            v[row] = np.where(r[row] < 0.3, zeros, sign * np.abs(v[row]))
        elif c in (9, 10):
            v[row] = np.inf if c == 9 else -np.inf
    return v, hi, lo, idx, m


def _grid_adversarial(s, k, w, seed):
    """_grid windows with NaN, +-inf (and both: a NaN sum), +-0 ties at
    the min and the max, all-inf series, and the grids' padding: the last
    quarter of the series and the last eighth of the lanes empty."""
    v, m = _grid(s, k, w, seed)
    r = np.random.default_rng(seed + 1).random((s, k, w))
    zeros = np.where(r < 0.15, -0.0, 0.0)
    for row in range(s):
        c = row % 8
        if c == 1:
            v[row, 0, ::3] = np.nan
            m[row, 0, ::3] = True
        elif c in (2, 3, 4):
            pos = np.where(r[row] < 0.1, np.inf, v[row])
            neg = np.where(r[row] < 0.1, -np.inf, v[row])
            v[row] = {2: pos, 3: neg, 4: np.where(r[row] < 0.05, np.inf,
                                                  neg)}[c]
        elif c in (5, 6):
            sign = 1.0 if c == 5 else -1.0
            v[row] = np.where(r[row] < 0.3, zeros[row], sign * np.abs(v[row]))
        elif c == 7:
            v[row] = np.inf
    m[s - s // 4:] = False
    m[:, :, w - w // 8:] = False
    return v, m


@pytest.mark.parametrize("mask", ["random", "prefix"])
@pytest.mark.parametrize("g,w", [(16, 16), (16, 64), (11, 256), (11, 1024)])
def test_bucket_plain_matches_pallas_and_xla_on_adversarial_rows(g, w, mask):
    v, hi, lo, idx, m = _bucket_adversarial(g, w, 200 + g + w, mask)
    got = _port(cs.bucket_stats_selectors(*_t(v, hi, lo, idx, m)))
    _assert_same(got, _np(ps.bucket_stats_selectors(v, hi, lo, idx, m)),
                 "pallas selectors")
    _assert_same(got, _np(_xla("selectors")(v, hi, lo, idx, m)),
                 "xla selectors")
    got = _port(cs.bucket_stats_basic(*_t(v, m)))
    _assert_same(got, _np(ps.bucket_stats_basic(v, hi, lo, idx, m)),
                 "pallas basic")
    _assert_same(got, _np(_xla("basic")(v, hi, lo, idx, m)), "xla basic")


@pytest.mark.parametrize("s,k,w", [(16, 6, 24), (8, 13, 16), (9, 2, 33)])
def test_grid_window_plain_matches_pallas_and_xla_on_adversarial_windows(
        s, k, w):
    v, m = _grid_adversarial(s, k, w, seed=300 + s + k + w)
    got = _port(cs.grid_window_agg(*_t(v, m)))
    assert np.isnan(got["min"]).any() and np.isposinf(got["max"]).any()
    _assert_same(got, _np(ps.grid_window_agg_t(v, m)), "pallas")
    _assert_same(got, _np(jseg.grid_window_agg_t(v, m)), "xla")


# -- the selector kernel's one-pass merge, modelled in numpy -------------------

_KEY_MAX = np.iinfo(np.int64).max
_KEY_MIN = np.iinfo(np.int64).min


def _merge_time(a, b, latest):
    """csrc/bucket_selectors.cu merge_time: extreme key, then larger
    value, then lower column; picks are [value, key, column, nan]."""
    if (b[1] > a[1]) if latest else (b[1] < a[1]):
        return list(b)
    a = list(a)
    if b[1] == a[1]:
        a[3] |= b[3]
        if b[0] > a[0] or (b[0] == a[0] and b[2] < a[2]):
            a[0], a[2] = b[0], b[2]
    return a


def _merge_value(a, b, is_max):
    """merge_value: NaN marks; smaller (larger) value, then earlier key,
    then lower column."""
    a = list(a)
    a[3] |= b[3]
    better = (b[0] > a[0]) if is_max else (b[0] < a[0])
    if better or (b[0] == a[0] and (b[1] < a[1] or (b[1] == a[1]
                                                    and b[2] < a[2]))):
        a[0], a[1], a[2] = b[0], b[1], b[2]
    return a


def _fold(p, x, k, col):
    """Picks.fold: one masked-in element, columns in increasing order."""
    nan = int(x != x)
    for name, latest in (("first", False), ("last", True)):
        a = p[name]
        if (k > a[1]) if latest else (k < a[1]):
            p[name] = [x, k, col, nan]
        elif k == a[1]:
            a[3] |= nan
            if x > a[0]:
                a[0], a[2] = x, col
    for name, is_max in (("min", False), ("max", True)):
        a = p[name]
        a[3] |= nan
        if ((x > a[0]) if is_max else (x < a[0])) or (x == a[0] and k < a[1]):
            p[name] = [x, k, col, a[3]]


def _one_pass_model(v, hi, lo, idx, m, lanes, vec):
    """The selector kernel's algorithm on one row at a time: `lanes` (a
    power of two) lanes, lane q folding column groups q, q + lanes, ...
    of `vec` columns in order, then the xor-shuffle tree over the lanes,
    then the column rules (a pick without a key or with a NaN selects
    W - 1)."""
    g, w = v.shape
    key = hi.astype(np.int64) * (1 << 30) + lo
    out = {k: [] for k in ("first", "last", "sel_first", "sel_last",
                           "sel_min", "sel_max")}
    for row in range(g):
        picks = []
        for q in range(lanes):
            p = {"first": [0.0, _KEY_MAX, 2**31 - 1, 0],
                 "last": [0.0, _KEY_MIN, 2**31 - 1, 0],
                 "min": [np.inf, _KEY_MAX, 2**31 - 1, 0],
                 "max": [-np.inf, _KEY_MAX, 2**31 - 1, 0]}
            for grp in range(q, w // vec, lanes):
                for col in range(grp * vec, grp * vec + vec):
                    if m[row, col]:
                        _fold(p, float(v[row, col]), int(key[row, col]), col)
            picks.append(p)
        o = lanes // 2
        while o:
            picks = [{"first": _merge_time(a["first"], b["first"], False),
                      "last": _merge_time(a["last"], b["last"], True),
                      "min": _merge_value(a["min"], b["min"], False),
                      "max": _merge_value(a["max"], b["max"], True)}
                     for a, b in ((picks[i], picks[i ^ o])
                                  for i in range(lanes))]
            o //= 2
        p = picks[0]

        def col(pick, empty):
            return w - 1 if pick[1] == empty or pick[3] else pick[2]

        cf, cl = col(p["first"], _KEY_MAX), col(p["last"], _KEY_MIN)
        out["first"].append(v[row, cf])
        out["last"].append(v[row, cl])
        out["sel_first"].append(idx[row, cf])
        out["sel_last"].append(idx[row, cl])
        out["sel_min"].append(idx[row, col(p["min"], _KEY_MAX)])
        out["sel_max"].append(idx[row, col(p["max"], _KEY_MAX)])
    return {k: np.asarray(x, dtype=v.dtype if k in ("first", "last")
                          else np.int32) for k, x in out.items()}


def _tie_rows(g, w, seed):
    """Rows full of value and time ties: values from {-1, -0.0, 0.0, 1,
    2}, times from three (hi, lo) pairs, 60% masks with empty and
    prefix rows; every fourth row also holds +-inf, every seventh a
    NaN."""
    rng = np.random.default_rng(seed)
    v = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0, 2.0]), size=(g, w))
    r = rng.random((g, w))
    v[::4] = np.where(r[::4] < 0.1, np.inf, np.where(r[::4] < 0.2, -np.inf,
                                                     v[::4]))
    v[3::7] = np.where(r[3::7] < 0.05, np.nan, v[3::7])
    hi = rng.integers(0, 2, size=(g, w)).astype(np.int32)
    lo = rng.integers(0, 2, size=(g, w)).astype(np.int32)
    idx = rng.permutation(g * w).reshape(g, w).astype(np.int32)
    m = rng.random((g, w)) < 0.6
    m[1::6] = False
    m[2::6] = np.arange(w)[None, :] < rng.integers(1, w + 1, size=(
        m[2::6].shape[0], 1))
    return v, hi, lo, idx, m


def _kernel_lanes(w):
    """(lanes per row, columns per lane step) as the selector kernel's
    launch picks them for width w (aligned inputs)."""
    vec = 4 if w % 4 == 0 else 1
    lanes = 1
    while 2 * lanes <= 32 and 2 * lanes <= w // vec:
        lanes *= 2
    return lanes, vec


@pytest.mark.parametrize("w,split", [
    (1, "kernel"), (12, "kernel"), (13, "kernel"), (16, "kernel"),
    (64, "kernel"), (256, "kernel"), (1024, "kernel"), (33, "kernel"),
    (64, (32, 1)), (16, (1, 1)), (24, (2, 4))])
def test_one_pass_merge_model_equals_plain_selectors(w, split):
    """The one-pass min/max (and first/last) merge, lane split and
    shuffle tree included, picks what the two-pass plain version picks
    on rows full of ties, +-inf, NaN and empty and prefix masks."""
    lanes, vec = _kernel_lanes(w) if split == "kernel" else split
    v, hi, lo, idx, m = _tie_rows(16 if w < 1024 else 6, w, seed=400 + w)
    want = _port(cs.bucket_stats_selectors_plain(*_t(v, hi, lo, idx, m)))
    _assert_same(_one_pass_model(v, hi, lo, idx, m, lanes, vec), want,
                 f"model lanes={lanes} vec={vec}")


# -- kernel 1's order of additions, modelled in numpy ---------------------------


def _basic_lanes(w, vec=None):
    """(lanes per row, columns per lane step) as kernel 1's launch picks
    them for width w: 4 columns a step where w is a multiple of 4 (aligned
    inputs), else 1; the fewest lanes (a power of two <= 32) that leave a
    lane at most 32 values."""
    vec = vec or (4 if w % 4 == 0 else 1)
    groups, held = w // vec, 32 // vec
    lanes = 1
    while lanes < 32 and lanes * held < groups:
        lanes *= 2
    return lanes, vec


def _nan_min(a, b):
    """ogt::nan_min: a when a < b or a is NaN, else b."""
    return a if (a < b or a != a) else b


def _nan_max(a, b):
    return a if (a > b or a != a) else b


def _lane_tree(parts, op):
    """The xor-shuffle tree over len(parts) lanes: at each stride o lane
    i takes op(its own, lane i ^ o's); lane 0's result."""
    o = len(parts) // 2
    while o:
        parts = [op(parts[i], parts[i ^ o]) for i in range(len(parts))]
        o //= 2
    return parts[0]


def _basic_model(v, m, lanes, vec):
    """Kernel 1's arithmetic, one row at a time: lane q folds column
    groups q, q + lanes, ... of vec columns in order (a group whose mask
    bytes are all zero is skipped, a masked-out column of any other group
    adds 0.0), the lane tree reduces count, sum, min and max, the mean is
    taken in the data type, then each lane folds (x - mean)^2 over the
    same columns and a second tree sums the ssd."""
    g, w = v.shape
    groups = w // vec
    out = {k: [] for k in ("count", "sum", "mean", "min", "max", "ssd")}
    for row in range(g):
        x, on = v[row].tolist(), m[row].tolist()
        cols = [[c for grp in range(q, groups, lanes)
                 if any(on[grp * vec:grp * vec + vec])
                 for c in range(grp * vec, grp * vec + vec)]
                for q in range(lanes)]
        parts = []
        for lane in cols:
            c, s, mn, mx = 0, 0.0, np.inf, -np.inf
            for col in lane:
                c += int(on[col])
                s += x[col] if on[col] else 0.0
                if on[col]:
                    mn, mx = _nan_min(mn, x[col]), _nan_max(mx, x[col])
            parts.append((c, s, mn, mx))
        cnt = _lane_tree([p[0] for p in parts], lambda a, b: a + b)
        total = _lane_tree([p[1] for p in parts], lambda a, b: a + b)
        mean = total / max(cnt, 1)
        d2 = []
        for lane in cols:
            acc = 0.0
            for col in lane:
                d = x[col] - mean
                acc += d * d if on[col] else 0.0
            d2.append(acc)
        out["count"].append(cnt)
        out["sum"].append(total)
        out["mean"].append(mean)
        out["min"].append(_lane_tree([p[2] for p in parts], _nan_min))
        out["max"].append(_lane_tree([p[3] for p in parts], _nan_max))
        out["ssd"].append(_lane_tree(d2, lambda a, b: a + b))
    return {k: np.asarray(x, dtype=np.int32 if k == "count" else v.dtype)
            for k, x in out.items()}


@pytest.mark.parametrize("mask", ["random", "prefix", "empty"])
@pytest.mark.parametrize("w,split", [
    (1, "kernel"), (12, "kernel"), (13, "kernel"), (16, "kernel"),
    (33, "kernel"), (64, "kernel"), (256, "kernel"), (1024, "kernel"),
    (2048, "kernel"), (16, "scalar"), (64, "scalar"), (256, "scalar"),
    (1024, "scalar")])
def test_basic_model_matches_plain_and_pallas(w, split, mask):
    """Kernel 1's order of additions (lanes from W, V columns a step, the
    two shuffle trees; "scalar": V = 1, the path of unaligned views) gives
    the plain version's and the TPU kernel's count/min/max exactly and
    their sum/mean/ssd within rtol 1e-10, on adversarial rows (NaN, +-inf,
    +-0 ties, empty rows) and rows with a large common offset."""
    lanes, vec = _basic_lanes(w, 1 if split == "scalar" else None)
    if split == "scalar":
        assert w % 4 == 0  # the vector path's widths, taken one column a step
    v, hi, lo, idx, m = _bucket_adversarial(
        15, w, 800 + w, "random" if mask == "empty" else mask)
    v[11:] = _large_offset_rows(4, w, seed=900 + w)
    if mask == "empty":
        m[:] = False
    got = _basic_model(v, m, lanes, vec)
    _assert_same(got, _port(cs.bucket_stats_basic_plain(*_t(v, m))),
                 f"plain lanes={lanes} vec={vec}", rtol=1e-10)
    _assert_same(got, _np(ps.bucket_stats_basic(v, hi, lo, idx, m)),
                 f"pallas lanes={lanes} vec={vec}", rtol=1e-10)


def test_basic_lanes_hold_every_ladder_width_in_one_batch():
    """At every width of the bucket ladder (models/ragged.py WIDTHS), on
    both paths, a lane's columns fit the 32 values kernel 1 holds in
    registers: the row is read once. Narrow rows share a warp."""
    for w in (16, 64, 256, 1024):
        for vec in (4, 1):
            lanes, _ = _basic_lanes(w, vec)
            assert -(-(w // vec) // lanes) * vec <= 32, (w, vec)
    assert [_basic_lanes(w)[0] for w in (16, 64, 256, 1024)] == [1, 2, 8, 32]
    lanes, vec = _basic_lanes(2048)
    assert -(-(2048 // vec) // lanes) * vec > 32  # the two-read path


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows", [5, 3, 0])
def test_basic_outputs_are_disjoint_views_of_one_buffer(dtype, rows):
    """The one allocation behind kernel 1's outputs: sum, mean, min, max,
    ssd of the dtype and the int32 count, each (rows,), contiguous, in
    one storage and disjoint."""
    outs, cnt = cs._basic_outputs(dtype, rows, torch.device("cpu"))
    views = (*outs, cnt)
    base = views[0].untyped_storage().data_ptr()
    spans = sorted((t.data_ptr() - base,
                    t.data_ptr() - base + rows * t.element_size())
                   for t in views)
    assert all(t.untyped_storage().data_ptr() == base for t in views)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= views[0].untyped_storage().nbytes()
    assert all(t.is_contiguous() for t in views)
    assert [t.dtype for t in views] == [dtype] * 5 + [torch.int32]
    assert all(t.shape == (rows,) for t in views)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows,w", [(5, 16), (3, 13), (0, 16)])
def test_wrapper_outputs_are_disjoint_views_of_one_buffer(dtype, rows, w):
    """The one allocation behind kernels 2 and 3's outputs: every view
    contiguous, of its dtype and shape, in one storage, disjoint; the
    grid's float views 16-byte aligned where W allows 16-byte vectors."""
    dev = torch.device("cpu")
    outs, cnt = cs._grid_outputs(dtype, rows, w, dev)
    (first, last), sels = cs._selector_outputs(dtype, rows * w, dev)
    for views, n in (((*outs, cnt), rows * w), ((first, last, *sels),
                                               rows * w)):
        base = views[0].untyped_storage().data_ptr()
        spans = sorted((t.data_ptr() - base,
                        t.data_ptr() - base + n * t.element_size())
                       for t in views)
        assert all(t.untyped_storage().data_ptr() == base for t in views)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] <= views[0].untyped_storage().nbytes()
        assert all(t.is_contiguous() for t in views)
    assert [t.dtype for t in (*outs, cnt)] == [dtype] * 4 + [torch.int32]
    assert [t.shape for t in (*outs, cnt)] == [(rows, w)] * 5
    assert [t.dtype for t in (first, last, *sels)] == \
        [dtype] * 2 + [torch.int32] * 4
    assert all(t.shape == (rows * w,) for t in (first, last, *sels))
    if w % (16 // dtype.itemsize) == 0:
        base = outs[0].data_ptr()
        assert all((t.data_ptr() - base) % 16 == 0 for t in (*outs, cnt))


def _card(d):
    return {k: x.cpu().numpy() for k, x in d.items()}


def _on_card(a, offset=False):
    """A CPU tensor's copy on the card; offset: starting one element into
    its storage (not 16-byte aligned: the kernels' scalar path)."""
    flat = torch.empty(a.numel() + int(offset), dtype=a.dtype, device="cuda")
    out = flat[int(offset):].view(a.shape)
    out.copy_(a)
    return out


def _assert_card(got, want, what):
    """Kernel against plain on the card: exact outputs exactly, sums and
    means within 1e-10 (summation order)."""
    for k in want:
        if k in EXACT:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what}.{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-10,
                                       err_msg=f"{what}.{k}")


def _assert_card_f32_basic(got, want, what):
    """Kernel 1 against plain in f32 on whole numbers: count, sum, min and
    max exactly (every sum of whole numbers below 2^24 is exact in any
    order), mean and ssd within 1e-5 ((x - mean)^2 rounds at each term, in
    another order, f32 epsilon 1.2e-7)."""
    for k in want:
        if k in ("count", "sum", "min", "max"):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what}.{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"{what}.{k}")


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    cs.reset_launches()
    calls = {"bucket_stats_basic": 0, "bucket_stats_selectors": 0,
             "grid_window_agg": 0}
    buckets = [(_bucket(64, 256, seed=21), False, torch.float64)]
    for (g, w), mask in (((64, 1024), "random"), ((37, 16), "prefix"),
                         ((37, 13), "random"), ((37, 2048), "prefix")):
        rows = _bucket_adversarial(g, w, 500 + w, mask)
        buckets += [(rows, False, torch.float64), (rows, True, torch.float64)]
    for w in (16, 1024, 2048):  # a large common offset: kernel 1's ssd
        big = list(_bucket(37, w, seed=550 + w))
        big[0] = _large_offset_rows(37, w, seed=560 + w)
        buckets += [(tuple(big), False, torch.float64),
                    (tuple(big), True, torch.float64)]
    for w in (64, 1024):
        f32 = list(_bucket_adversarial(37, w, 600 + w, "prefix"))
        f32[0] = np.floor(f32[0])  # whole numbers: f32 sums exact in any order
        buckets.append((tuple(f32), False, torch.float32))
    for rows, offset, dtype in buckets:
        args = _t(*rows)
        args = (args[0].to(dtype),) + args[1:]
        dev = tuple(_on_card(a, offset) for a in args)
        what = f"{tuple(args[0].shape)} offset={offset} {dtype}"
        _assert_card(_card(cs.bucket_stats_selectors(*dev)),
                     _port(cs.bucket_stats_selectors_plain(*args)),
                     f"selectors {what}")
        calls["bucket_stats_selectors"] += 1
        assert_basic = _assert_card if dtype == torch.float64 else \
            _assert_card_f32_basic
        assert_basic(_card(cs.bucket_stats_basic(dev[0], dev[4])),
              _port(cs.bucket_stats_basic_plain(args[0], args[4])),
              f"basic {what}")
        calls["bucket_stats_basic"] += 1
    grids = [(_grid(16, 6, 96, seed=22), False, torch.float64)]
    for s_dim, k, w in ((16, 361, 16), (16, 6, 768), (9, 2, 33), (13, 361, 12)):
        cells = _grid_adversarial(s_dim, k, w, 700 + k + w)
        grids += [(cells, False, torch.float64), (cells, True, torch.float64),
                  ((np.floor(cells[0]), cells[1]), False, torch.float32)]
    for cells, offset, dtype in grids:
        tg = _t(*cells)
        tg = (tg[0].to(dtype), tg[1])
        got = _card(cs.grid_window_agg(*(_on_card(a, offset) for a in tg)))
        _assert_card(got, _port(cs.grid_window_agg_plain(*tg)),
                     f"grid {tuple(tg[0].shape)} offset={offset} {dtype}")
        calls["grid_window_agg"] += 1
    assert {k: cs.LAUNCHES[k] for k in calls} == calls
