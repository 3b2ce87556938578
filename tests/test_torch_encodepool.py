"""The port's encode pool (storage/encodepool.py) against the JAX
package, on the CPU.

The reference's tests/test_encodepool.py cases for the ordered pipe and
its serial A-B switch run on the port: results drain in submission order
whatever order the jobs finish in, one worker (or ``forced_serial()`` on
the calling thread) encodes inline, an abort cancels what is queued, a
worker's error surfaces on the writer thread, and a flush or a
compaction writes the same bytes pooled and serial; those bytes are the
JAX package's own for the same points.
"""

from __future__ import annotations

import os
import random
import threading
import time

import pytest

from opengemini_tpu.record import FieldType as JFieldType
from opengemini_tpu.storage import encodepool as jencodepool
from opengemini_tpu.storage.shard import Shard as JShard
from opengemini_tpu_torch.record import FieldType as TFieldType
from opengemini_tpu_torch.storage import encodepool
from opengemini_tpu_torch.storage.shard import Shard as TShard

NS = 1_000_000_000
BASE = 1_700_000_000 * NS


@pytest.fixture
def pool_on(monkeypatch):
    """The port's encode pool live with 4 workers, whatever the cores."""
    prev = encodepool._pool
    monkeypatch.setattr(encodepool, "WORKERS", 4)
    monkeypatch.setattr(encodepool, "_pool", None)
    yield
    forced = encodepool._pool
    monkeypatch.setattr(encodepool, "_pool", None)
    if forced is not None and forced is not prev:
        forced.shutdown(wait=True)


def test_consume_in_submission_order_despite_shuffled_completion(pool_on):
    rng = random.Random(3)
    delays = [rng.uniform(0, 0.01) for _ in range(40)]
    got = []
    pipe = encodepool.OrderedEncodePipe(got.append)
    assert pipe.pooled
    for i in range(40):
        def job(i=i):
            time.sleep(delays[i])  # later jobs often finish first
            return i
        pipe.submit(job, 1)
    pipe.drain()
    assert got == list(range(40))


def test_oversized_single_job_still_admitted(pool_on, monkeypatch):
    monkeypatch.setattr(encodepool, "INFLIGHT_BYTES", 10)
    done = []
    pipe = encodepool.OrderedEncodePipe(done.append)
    for i in range(4):
        pipe.submit(lambda i=i: i, 10**9)
        assert pipe._inflight == 10**9  # one admitted at a time
    pipe.drain()
    assert done == [0, 1, 2, 3]


def test_workers_one_means_serial_inline(monkeypatch):
    monkeypatch.setattr(encodepool, "WORKERS", 1)
    assert not encodepool.enabled()
    assert encodepool.pool() is None
    order = []

    def job():
        order.append("encode")
        return 7

    pipe = encodepool.OrderedEncodePipe(lambda v: order.append(("write", v)))
    assert not pipe.pooled
    pipe.submit(job, 1)  # consumed at once: the serial interleaving
    assert order == ["encode", ("write", 7)]
    pipe.drain()


def test_forced_serial_degrades_calling_thread(pool_on):
    with encodepool.forced_serial():
        assert not encodepool.enabled()
        pipe = encodepool.OrderedEncodePipe(lambda v: None)
        assert not pipe.pooled
        # thread-local: another thread still encodes pooled
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            encodepool.OrderedEncodePipe(lambda v: None).pooled))
        t.start()
        t.join()
        assert seen == [True]
    assert encodepool.enabled()
    assert encodepool.OrderedEncodePipe(lambda v: None).pooled


def test_forced_serial_nests_and_restores(pool_on):
    with encodepool.forced_serial():
        with encodepool.forced_serial():
            assert not encodepool.enabled()
        assert not encodepool.enabled()
    assert encodepool.enabled()


def test_abort_cancels_pending(pool_on):
    ran = []

    def mk(i):
        def job():
            time.sleep(0.01)
            ran.append(i)
            return i
        return job

    # under max_pending (4 x WORKERS): submit never drains, so every job
    # is queued or running when the abort comes
    pipe = encodepool.OrderedEncodePipe(lambda v: None)
    for i in range(15):
        pipe.submit(mk(i), 1)
    pipe.abort()
    time.sleep(0.3)
    assert len(ran) < 15  # queued futures were cancelled, never ran
    assert not pipe._pending
    assert encodepool.total_inflight_bytes() == 0


def test_worker_error_surfaces_on_writer_thread(pool_on):
    pipe = encodepool.OrderedEncodePipe(lambda v: None)

    def boom():
        raise ValueError("encode failed")

    pipe.submit(boom, 1)
    with pytest.raises(ValueError, match="encode failed"):
        pipe.drain()


def _points(ft, hosts=80, points=120, strings=True):
    """A packed-eligible measurement (>= PACK_MIN_SERIES series), a
    small per-series one with strings and validity masks, and an int
    one: every encoder the writer owns."""
    pts = []
    for p in range(points):
        t = BASE + p * NS
        for h in range(hosts):
            pts.append(("hc", (("host", f"h{h:03d}"),), t,
                        {"v": (ft.FLOAT, float((h * 13 + p) % 37))}))
    for p in range(points):
        t = BASE + p * NS
        fields = {"u": (ft.INT, (p * 7) % 101), "b": (ft.BOOL, p % 3 == 0)}
        if strings and p % 2 == 0:  # odd rows miss 's': masks
            fields["s"] = (ft.STRING, f"lvl{p % 5}")
        pts.append(("small", (("k", "a"),), t, fields))
        pts.append(("small", (("k", "b"),), t, {"u": (ft.INT, p)}))
    return pts


def _tsf(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".tsf"))


def _bytes(path, name):
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


def test_flush_same_bytes(tmp_path, pool_on):
    """Pooled and serial flushes write the same files, byte for byte,
    and so does the JAX package's serial flush of the same points."""
    a = TShard(str(tmp_path / "a"), 0, 2**62)
    b = TShard(str(tmp_path / "b"), 0, 2**62)
    j = JShard(str(tmp_path / "j"), 0, 2**62)
    for sh in (a, b):
        sh.write_points_structured(_points(TFieldType))
    j.write_points_structured(_points(JFieldType))
    a.flush()
    with encodepool.forced_serial():
        b.flush()
    with jencodepool.forced_serial():
        j.flush()
    names = _tsf(a.path)
    assert names and names == _tsf(b.path) == _tsf(j.path)
    for name in names:
        got = _bytes(a.path, name)
        assert got == _bytes(b.path, name), f"pooled vs serial: {name}"
        assert got == _bytes(j.path, name), f"port vs JAX: {name}"
    assert a.content_digest() == b.content_digest()
    for sh in (a, b, j):
        sh.close()


def test_compaction_same_bytes_and_digest(tmp_path, pool_on):
    shards = []
    for sub in ("a", "b"):
        sh = TShard(str(tmp_path / sub), 0, 2**62)
        sh.write_points_structured(_points(TFieldType, hosts=70, points=40))
        sh.flush()
        sh.write_points_structured([
            ("small", (("k", "a"),), BASE + (500 + i) * NS,
             {"u": (TFieldType.INT, i)}) for i in range(50)])
        sh.flush()
        shards.append(sh)
    a, b = shards
    assert a.compact()
    with encodepool.forced_serial():
        assert b.compact()
    assert _bytes(a.path, _tsf(a.path)[0]) == _bytes(b.path, _tsf(b.path)[0])
    assert a.content_digest() == b.content_digest()
    a.close()
    b.close()
