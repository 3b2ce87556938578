"""Bulk load of stored series into the port's engine.

A database's stored data plays the part a model's weights play: this is
how data held elsewhere (for example what a JAX-package shard scan
yields, ``read_series_bulk``) moves into an ``Engine`` of the port,
through its columnar write path. The load logs its rows to the shard
WALs as line-protocol text (ingest/native_lp.LineWriter) before it
applies them, so they are durable when it returns, and a memtable past
the engine's flush threshold flushes as after any write.

``tables`` maps a measurement name to a dict of numpy arrays:

  series_keys  list of canonical series keys ("cpu,host=a,region=b",
               as ``ingest.line_protocol.series_key`` writes them)
  series       int[n]: row -> index into series_keys
  times        int64[n]: row timestamps in ns
  fields       {field name: (values[n], valid bool[n])}; the field type
               follows the values' dtype (float, int, bool, object=str)
"""

from __future__ import annotations

import numpy as np

from opengemini_tpu_torch.ingest.native_lp import ColumnarBatch
from opengemini_tpu_torch.record import np_to_field_type


def load_columnar(engine, db: str, tables: dict, rp: str | None = None) -> int:
    """Write every measurement of `tables` into `engine` (database `db`)
    as one columnar batch each. Returns rows written."""
    batches = []
    for mst, t in tables.items():
        keys = list(t["series_keys"])
        times = np.asarray(t["times"], dtype=np.int64)
        ref = np.asarray(t["series"], dtype=np.int64)
        if ref.shape != times.shape:
            raise ValueError(f"{mst}: series and times differ in length")
        cols = []
        for name in sorted(t["fields"]):
            values, valid = t["fields"][name]
            values = np.asarray(values)
            valid = np.asarray(valid, dtype=np.bool_)
            if values.shape != times.shape or valid.shape != times.shape:
                raise ValueError(f"{mst}.{name}: column length differs")
            cols.append((0, name, np_to_field_type(values.dtype), values,
                         valid))
        batches.append(ColumnarBatch(times, ref, keys,
                                     np.zeros(len(keys), dtype=np.int64),
                                     [mst], cols))
    return engine.load_columnar_batches(db, batches, rp=rp)
