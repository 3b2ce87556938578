"""The port's BloomFilter (utils/bloom.py) against the JAX package's, and
the TSF reader's per-measurement sid bloom, on the CPU."""

import numpy as np
import pytest

from opengemini_tpu.utils.bloom import BloomFilter as JBloomFilter
from opengemini_tpu_torch.storage.engine import Engine
from opengemini_tpu_torch.utils.bloom import BloomFilter


def _keys(rng, n):
    kinds = rng.integers(0, 3, n)
    out = []
    for k, v in zip(kinds, rng.integers(-(2**62), 2**62, n)):
        if k == 0:
            out.append(int(v))
        elif k == 1:
            out.append(f"cpu,hostname=host_{int(v) % 100000}")
        else:
            out.append(int(v).to_bytes(8, "little", signed=True) + b"k")
    return out


@pytest.mark.parametrize("seed,capacity,fp_rate", [
    (1, 1, 0.01), (2, 1000, 0.01), (3, 4000, 0.05), (4, 50, 0.001)])
def test_bloom_answers_as_jax_with_no_false_negatives(seed, capacity,
                                                      fp_rate):
    rng = np.random.default_rng(seed)
    present = _keys(rng, capacity)
    got, want = BloomFilter(capacity, fp_rate), JBloomFilter(capacity,
                                                             fp_rate)
    assert (got.m, got.k) == (want.m, want.k)
    for x in present:
        got.add(x)
        want.add(x)
    np.testing.assert_array_equal(got.bits, want.bits)
    assert all(x in got for x in present)  # no false negative
    probes = _keys(rng, 5000)
    assert [got.might_contain(x) for x in probes] == [
        want.might_contain(x) for x in probes]
    if capacity >= 1000:
        fp = sum(x in got for x in probes if x not in set(present))
        assert fp < 3 * fp_rate * len(probes) + 10


def test_tsf_reader_bloom_rejects_absent_sid(tmp_path):
    e = Engine(str(tmp_path / "b"), device="cpu")
    e.create_database("db")
    NS = 10**9
    e.write_lines("db", "\n".join(
        f"m,host=h{i} v={i} {(1_700_000_000 + i) * NS}" for i in range(20)))
    e.flush_all()
    [sh] = e.all_shards()
    r = sh._files[0]
    real_sids = {c.sid for c in r.chunks("m")}
    assert all(r.chunks("m", sids={s}) for s in real_sids)  # no false neg
    assert r.chunks("m", sids={max(real_sids) + 1000}) == []
    assert set(r._sid_bloom) == {"m"}
    e.close()
