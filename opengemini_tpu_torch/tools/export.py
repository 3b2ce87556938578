"""Parquet export tool (reference: lib/parquet TSSP->parquet writer).

  python -m opengemini_tpu_torch.tools.export -data DIR -db DB [-measurement M] -out OUT_DIR [-device cuda|cpu]

One parquet file per measurement: time (ns int64), one column per tag
(dictionary-encoded strings), one per field. Gated on pyarrow being
importable; everything else in the framework runs without it.

The port of ``opengemini_tpu/tools/export.py``, whole, with its imports
rewritten; ``-device`` names the engine's device (default cuda, as the
port's ts-server main).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


class ExportError(Exception):
    pass


def export_measurement(engine, db: str, mst: str, out_path: str) -> int:
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:  # pragma: no cover
        raise ExportError("pyarrow is required for parquet export") from e

    shards = engine.shards_of_db(db)  # all retention policies
    tag_keys: list[str] = sorted(
        {k for sh in shards for k in sh.index.tag_keys(mst)}
    )
    rows_t: list[np.ndarray] = []
    tag_cols: dict[str, list] = {k: [] for k in tag_keys}
    field_cols: dict[str, list] = {}
    schema: dict = {}
    for sh in shards:
        schema.update(sh.schema(mst))
    field_names = sorted(schema)
    for name in field_names:
        field_cols[name] = []
    n_total = 0
    for sh in shards:
        for sid in sorted(sh.index.series_ids(mst)):
            rec = sh.read_series(mst, sid)
            if not len(rec):
                continue
            tags = sh.index.tags_of(sid)
            n = len(rec)
            n_total += n
            rows_t.append(rec.times)
            for k in tag_keys:
                tag_cols[k].extend([tags.get(k)] * n)
            for name in field_names:
                col = rec.columns.get(name)
                if col is None:
                    field_cols[name].extend([None] * n)
                else:
                    vals = col.values
                    valid = col.valid
                    field_cols[name].extend(
                        v if ok else None
                        for v, ok in zip(
                            (vals.tolist() if vals.dtype != object else vals), valid
                        )
                    )
    if n_total == 0:
        return 0
    arrays = {"time": pa.array(np.concatenate(rows_t), type=pa.int64())}
    for k in tag_keys:
        arrays[k] = pa.array(tag_cols[k], type=pa.string()).dictionary_encode()
    from opengemini_tpu_torch.record import FieldType

    type_map = {
        FieldType.FLOAT: pa.float64(),
        FieldType.INT: pa.int64(),
        FieldType.BOOL: pa.bool_(),
        FieldType.STRING: pa.string(),
    }
    for name in field_names:
        arrays[name] = pa.array(field_cols[name], type=type_map[schema[name]])
    table = pa.table(arrays)
    pq.write_table(table, out_path)
    return n_total


def main(argv=None) -> int:
    from opengemini_tpu_torch.storage.engine import Engine

    ap = argparse.ArgumentParser(prog="ts-export", description="TSF -> parquet")
    ap.add_argument("-data", required=True)
    ap.add_argument("-db", required=True)
    ap.add_argument("-measurement", default=None)
    ap.add_argument("-out", required=True)
    ap.add_argument("-device", default="cuda",
                    help="the torch device the engine opens on (default "
                         "cuda; cpu to run on the host)")
    args = ap.parse_args(argv)
    engine = Engine(args.data, device=args.device)
    try:
        os.makedirs(args.out, exist_ok=True)
        msts = (
            [args.measurement]
            if args.measurement
            else sorted({
                m for sh in engine.shards_of_db(args.db) for m in sh.measurements()
            })
        )
        total = 0
        for m in msts:
            out_path = os.path.join(args.out, f"{m}.parquet")
            n = export_measurement(engine, args.db, m, out_path)
            print(f"{m}: {n} rows -> {out_path}")
            total += n
        print(f"exported {total} rows")
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
