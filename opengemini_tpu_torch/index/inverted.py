"""Inverted tag index: tag postings -> series ids.

The role of the reference's mergeset-based tsi index
(engine/index/tsi/mergeset_index.go, search.go): map tag filters to series
id sets, series ids back to (measurement, tags). In-memory dict postings
with an append-only on-disk log for durability; high-cardinality scaling
later moves the postings into the C++ side, the API stays.

Persistence format (series.log): one JSON array per line,
    [sid, measurement, [[k, v], ...]]
appended on series creation and replayed on open — JSON so arbitrary tag
values (commas, tabs, '=') can never corrupt the log. Writes are buffered
by the shard's WAL-sync cadence.
"""

from __future__ import annotations

import json
import os
import re

from opengemini_tpu_torch.ingest.line_protocol import series_key


def parse_series_key(key: str) -> tuple[str, tuple]:
    """Inverse of line_protocol.series_key: canonical key ->
    (measurement, tags tuple). Components unescape with the parser's own
    helpers so the round-trip is exact."""
    from opengemini_tpu_torch.ingest.line_protocol import _split_escaped, _unescape

    segs = _split_escaped(key, ",")
    mst = _unescape(segs[0])
    tags = []
    for seg in segs[1:]:
        kv = _split_escaped(seg, "=")
        tags.append((_unescape(kv[0]), _unescape(kv[1])))
    return mst, tuple(tags)


class SeriesIndex:
    def __init__(self, path: str | None = None):
        self.path = path
        self.key_to_sid: dict[str, int] = {}
        self.sid_to_series: dict[int, tuple[str, tuple]] = {}
        # measurement -> set[sid]
        self.mst_sids: dict[str, set[int]] = {}
        # (measurement, tag_key, tag_value) -> set[sid]
        self.postings: dict[tuple[str, str, str], set[int]] = {}
        self._next_sid = 1
        # label-engine invalidation protocol (see index.labels): bumped
        # per measurement on insert, index-wide on removal
        self._label_gens: dict[str, int] = {}
        self._label_epoch = 0
        self._log = None
        if path is not None:
            self._replay()
            self._log = open(path, "a", encoding="utf-8")

    # -- write side ---------------------------------------------------------

    def get_or_create(self, measurement: str, tags: tuple) -> int:
        key = series_key(measurement, tags)
        sid = self.key_to_sid.get(key)
        if sid is not None:
            return sid
        return self._insert_logged(measurement, tags, key)

    def get_or_create_by_key(self, key: str) -> int:
        """Canonical-key ingest path (the native parser hands keys, not
        tag tuples); repeat series skip the tag reconstruction entirely."""
        sid = self.key_to_sid.get(key)
        if sid is not None:
            return sid
        measurement, tags = parse_series_key(key)
        return self._insert_logged(measurement, tags, key)

    def _insert_logged(self, measurement: str, tags: tuple, key: str) -> int:
        sid = self._insert(measurement, tags, key)
        if self._log is not None:
            self._log.write(
                json.dumps([sid, measurement, [list(t) for t in tags]]) + "\n"
            )
        return sid

    def _insert(self, measurement: str, tags: tuple, key: str, sid: int | None = None) -> int:
        if sid is None:
            sid = self._next_sid
        self._next_sid = max(self._next_sid, sid + 1)
        self.key_to_sid[key] = sid
        self.sid_to_series[sid] = (measurement, tags)
        self.mst_sids.setdefault(measurement, set()).add(sid)
        for k, v in tags:
            self.postings.setdefault((measurement, k, v), set()).add(sid)
        self._label_gens[measurement] = \
            self._label_gens.get(measurement, 0) + 1
        return sid

    def label_gen(self, measurement: str) -> tuple:
        return (self._label_epoch, self._label_gens.get(measurement, 0))

    def flush(self) -> None:
        if self._log is not None:
            self._log.flush()
            os.fsync(self._log.fileno())

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None

    def _replay(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                try:
                    sid, measurement, tag_list = json.loads(line)
                except ValueError:
                    continue  # torn tail from a crash mid-append
                tags = tuple((k, v) for k, v in tag_list)
                self._insert(measurement, tags, series_key(measurement, tags), sid)

    # -- read side ----------------------------------------------------------

    def series_ids(self, measurement: str) -> set[int]:
        return set(self.mst_sids.get(measurement, ()))

    def tag_values(self, measurement: str, key: str) -> list[str]:
        vals = {
            v
            for (m, k, v) in self.postings
            if m == measurement and k == key
        }
        return sorted(vals)

    def tag_keys(self, measurement: str) -> list[str]:
        return sorted({k for (m, k, _v) in self.postings if m == measurement})

    def _with_key(self, measurement: str, key: str) -> set[int]:
        out: set[int] = set()
        for (m, k, _v), sids in self.postings.items():
            if m == measurement and k == key:
                out |= sids
        return out

    def match_eq(self, measurement: str, key: str, value: str) -> set[int]:
        if value == "":
            # influx: a missing tag equals the empty string
            # (server_test.go With_EmptyTags 'where empty tag'); an
            # explicit '' posting matches too
            return (self.series_ids(measurement)
                    - self._with_key(measurement, key)) | set(
                self.postings.get((measurement, key, ""), ()))
        return set(self.postings.get((measurement, key, value), ()))

    def match_neq(self, measurement: str, key: str, value: str) -> set[int]:
        return self.series_ids(measurement) - self.match_eq(measurement, key, value)

    def match_regex(self, measurement: str, key: str, pattern: str, negate: bool = False) -> set[int]:
        rx = re.compile(pattern)
        hit: set[int] = set()
        for (m, k, v), sids in self.postings.items():
            if m == measurement and k == key and rx.search(v):
                hit |= sids
        if rx.search(""):
            # the missing tag is "" and it matches: series without the
            # key match the pattern too
            hit |= self.series_ids(measurement) - self._with_key(
                measurement, key)
        if negate:
            return self.series_ids(measurement) - hit
        return hit

    def tags_of(self, sid: int) -> dict[str, str]:
        return dict(self.sid_to_series[sid][1])

    def series_entry(self, sid: int) -> tuple[str, tuple]:
        return self.sid_to_series[sid]

    def iter_series_entries(self):
        yield from self.sid_to_series.values()

    def measurements(self) -> list[str]:
        return sorted(self.mst_sids)

    # -- deletion ------------------------------------------------------------

    def remove_sids(self, sids: set[int]) -> None:
        """Drop series from the index and rewrite the log (reference: tsi
        DeleteSeries / DropMeasurement index paths)."""
        for sid in sids:
            entry = self.sid_to_series.pop(sid, None)
            if entry is None:
                continue
            mst, tags = entry
            self.key_to_sid.pop(series_key(mst, tags), None)
            bucket = self.mst_sids.get(mst)
            if bucket is not None:
                bucket.discard(sid)
                if not bucket:
                    del self.mst_sids[mst]
            for k, v in tags:
                post = self.postings.get((mst, k, v))
                if post is not None:
                    post.discard(sid)
                    if not post:
                        del self.postings[(mst, k, v)]
        self._label_epoch += 1
        self._rewrite_log()

    def _rewrite_log(self) -> None:
        if self.path is None:
            return
        if self._log is not None:
            self._log.close()
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for sid, (mst, tags) in sorted(self.sid_to_series.items()):
                f.write(json.dumps([sid, mst, [list(t) for t in tags]]) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._log = open(self.path, "a", encoding="utf-8")
