"""CPU-side (numpy) window/segment-id derivation.

Timestamps are int64 nanoseconds and never go to the device raw: window
indices and group ids are derived here exactly in int64, and only compact
int32 segment ids plus int32 *relative* times (ms) are transferred. This
keeps device arrays narrow and avoids int64 on TPU (where x64 is disabled).

Replaces the reference's per-row `getIntervalIndex`
(engine/aggregate_cursor.go:343) with a vectorized bucketize.
"""

from __future__ import annotations

import numpy as np

MIN_TIME = -(2**63) + 1
MAX_TIME = 2**63 - 1


def window_start(t_ns: np.ndarray | int, every_ns: int, offset_ns: int = 0):
    """InfluxDB GROUP BY time() bucket start: epoch-aligned floor.

    wstart = floor((t - offset) / every) * every + offset  (floor division,
    exact for negative times too — numpy // is floor division on int64).
    """
    return (t_ns - offset_ns) // every_ns * every_ns + offset_ns


def window_index(
    times_ns: np.ndarray,
    range_start_ns: int,
    every_ns: int,
    offset_ns: int = 0,
) -> tuple[np.ndarray, int]:
    """Map each timestamp to a window ordinal relative to the (aligned)
    range start. Returns (int32 indices, aligned_start_ns).

    Callers mask rows outside [aligned_start, range_end) themselves; indices
    for such rows may be negative or past the window count.
    """
    aligned = int(window_start(range_start_ns, every_ns, offset_ns))
    idx = (times_ns - offset_ns) // every_ns - (aligned - offset_ns) // every_ns
    return idx.astype(np.int32), aligned


def num_windows(range_start_ns: int, range_end_ns: int, every_ns: int, offset_ns: int = 0) -> int:
    """Number of buckets covering [range_start, range_end)."""
    aligned = int(window_start(range_start_ns, every_ns, offset_ns))
    if range_end_ns <= aligned:
        return 0
    return int((range_end_ns - 1 - offset_ns) // every_ns - (aligned - offset_ns) // every_ns) + 1


def tile_index(t_ms: np.ndarray, anchor_ms: int, g_ms: int) -> np.ndarray:
    """Left-OPEN right-CLOSED tile ordinal: tile i covers
    (anchor + i*g, anchor + (i+1)*g].

    The PromQL tiled range-vector engine's bucketize (ops/prom.py): prom
    windows are (s, e], so its tiles close on the right — the mirror of
    window_index's [start, end) InfluxQL buckets, same exact int64
    floor-division idiom, no searchsorted."""
    return (np.asarray(t_ms, np.int64) - anchor_ms - 1) // g_ms


def relative_ms(times_ns: np.ndarray, base_ns: int) -> np.ndarray:
    """int32 milliseconds relative to base — the device-side time column.

    ~24 days of range fit in int32 ms; shard time ranges (default 7d groups,
    reference lib/util/lifted/influx/meta shard-group durations) stay within
    this. Used only for first/last tie-breaking and prom rate windows.
    """
    rel = (times_ns - base_ns) // 1_000_000
    return rel.astype(np.int32)


def dictionary_encode(keys: list) -> tuple[np.ndarray, list]:
    """Dictionary-encode arbitrary hashable group keys to int32 codes.

    Group (tag-value) keys are encoded on CPU; the device only ever sees
    int32 codes (SURVEY.md §7 'String/tag columns').
    Returns (codes int32, unique keys in first-appearance order).
    """
    mapping: dict = {}
    codes = np.empty(len(keys), dtype=np.int32)
    uniques: list = []
    for i, k in enumerate(keys):
        code = mapping.get(k)
        if code is None:
            code = len(uniques)
            mapping[k] = code
            uniques.append(k)
        codes[i] = code
    return codes, uniques


def pad_to(n: int, multiple: int = 1024) -> int:
    """Pad row counts to coarse buckets so jit caches stay small
    (the reference's plan-template cache idea — engine/executor/select.go:121 —
    applied to array shapes)."""
    if n <= multiple:
        m = 8
        while m < n:
            m *= 2
        return max(m, 8)
    return ((n + multiple - 1) // multiple) * multiple
