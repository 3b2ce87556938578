"""The plain versions of the port's three CUDA kernels
(opengemini_tpu_torch/ops/cuda_segment.py) against the JAX package's
Pallas kernels, run directly (interpret mode on the CPU, as
tests/test_pallas.py runs them), and against the XLA oracles
(models/ragged._stats_jit('basic' / 'selectors_xla'),
ops/segment.grid_window_agg_t).

Inputs are made with numpy from a seed: 70% mask density, fully empty
rows, integer-valued rows (value ties) and rows with few distinct times
(time ties). count/min/max and every selector output must match
exactly; sum/mean/ssd within rtol 1e-12 (summation order).

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


def _assert_same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        a = np.asarray(got[k])
        b = np.asarray(want[k])
        assert a.shape == b.shape, (what, k)
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}.{k}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                       err_msg=f"{what}.{k}")


def _xla(kind):
    """The XLA oracle whatever the Pallas routing would pick."""
    fn = jragged._stats_jit("basic" if kind == "basic" else "selectors_xla")
    return fn


@pytest.mark.parametrize("g,w", [(16, 16), (16, 64), (8, 256), (8, 1024)])
def test_bucket_basic_plain_matches_pallas_and_xla(g, w):
    v, hi, lo, idx, m = _bucket(g, w, seed=g * 7 + w)
    got = _port(cs.bucket_stats_basic(*_t(v, m)))
    _assert_same(got, _np(ps.bucket_stats_basic(v, hi, lo, idx, m)), "pallas")
    _assert_same(got, _np(_xla("basic")(v, hi, lo, idx, m)), "xla")


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


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    v, hi, lo, idx, m = _bucket(64, 256, seed=21)
    args = _t(v, hi, lo, idx, m)
    dev = tuple(a.cuda() for a in args)
    cs.reset_launches()
    _assert_same(_port({k: x.cpu() for k, x in
                        cs.bucket_stats_selectors(*dev).items()}),
                 _port(cs.bucket_stats_selectors_plain(*args)), "card")
    got = {k: x.cpu() for k, x in cs.bucket_stats_basic(dev[0], dev[4]).items()}
    want = cs.bucket_stats_basic_plain(args[0], args[4])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-10, err_msg=k)
    gv, gm = _grid(16, 6, 96, seed=22)
    tg = _t(gv, gm)
    got = {k: x.cpu() for k, x in
           cs.grid_window_agg(*(a.cuda() for a in tg)).items()}
    want = cs.grid_window_agg_plain(*tg)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-10, err_msg=k)
    assert all(n == 1 for n in cs.LAUNCHES.values())
