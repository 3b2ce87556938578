"""Per-shard write-ahead log.

The port of ``opengemini_tpu/storage/wal.py``: the same frames on disk,
so either package replays the other's log. An entry is the raw
line-protocol batch (zlib-compressed) plus precision — replay re-parses
it — or a batch of structured points. Entry framing:

    [u32 len][u32 crc32][u8 kind][payload]

kind 1 = raw lines: [u8 precision_len][u64 now_ns][precision utf8][zlib(lines)]
kind 2 = structured points: [zlib(JSON [[mst, [[k,v]..], t, {f: [type, val]}]..])]
kind 3 = raw lines, UNCOMPRESSED: same layout as kind 1 with the lines
         stored verbatim (batches >= 1 MiB)

Corruption policy: a torn TAIL (the bad frame is the last decodable
thing in the log, a crash mid-append) is truncated on replay. An
INTERIOR bad frame, with valid frames after it, can only be media
damage: replay raises `WALCorruption`, which carries the salvageable
suffix (frames re-synced by scanning for the next valid header whose
CRC verifies), so the shard can re-apply the salvaged records and
rewrite a clean log — losing at most the one destroyed frame, loudly.

Segments: `rotate()` renames the live log aside (flush freezes the
memtable and rotates in one step); replay walks rotated segments
oldest first, then the live log. A rotated segment is removed only after
the TSF holding its rows is fsynced and published.

Group commit (sync=True): appends return a commit ticket; `commit(t)` —
called OUTSIDE the shard lock — coalesces concurrent callers into one
fsync. The first waiter becomes the leader, sleeps a 200 us gather
window when others are pending (the reference's default; its
`OGT_WAL_GROUP_COMMIT_US` knob is not ported), flushes, fires the
`wal-before-sync` failpoint once per fsync, fsyncs and wakes everyone it
covered. The disk-fault hooks (storage/diskfault.py) sit on the appends,
the fsyncs and the replay read; the failpoints (utils/failpoint.py) after
an append, before a sync and around the rotation's rename.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib

from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.storage import diskfault
from opengemini_tpu_torch.utils.failpoint import inject as _fp

_KIND_RAW_LINES = 1
_KIND_POINTS = 2
_KIND_RAW_LINES_PLAIN = 3  # uncompressed: large batches (see append_lines)
_KINDS = (_KIND_RAW_LINES, _KIND_POINTS, _KIND_RAW_LINES_PLAIN)
_HEADER = struct.Struct("<IIB")


class WALCorruption(Exception):
    """Interior WAL damage: a bad frame with valid frames after it.
    Carries the raw decodable frames before (`clean_frames`) and after
    (`salvaged_frames`) the damage."""

    def __init__(self, path: str, offset: int,
                 clean_frames: list, salvaged_frames: list):
        super().__init__(
            f"WAL {path}: interior corruption at offset {offset} "
            f"({len(salvaged_frames)} valid frame(s) salvaged after it)")
        self.path = path
        self.offset = offset
        self.clean_frames = clean_frames        # [(kind, payload)] pre-damage
        self.salvaged_frames = salvaged_frames  # [(kind, payload)] post-damage

    def salvaged_entries(self):
        """Decoded replay entries of the salvaged suffix (unknown kinds
        are preserved in the rewrite but have nothing to replay)."""
        return [WAL._decode_entry(kind, payload)
                for kind, payload in self.salvaged_frames
                if kind in _KINDS]


# batches above this skip zlib: compressing a bulk batch costs more wall
# time than writing it raw
_PLAIN_THRESHOLD = 1 << 20

# group-commit gather window: how long a sync leader waits for followers
GROUP_COMMIT_S = 200e-6


def frame(kind: int, payload: bytes) -> bytes:
    """One framed entry: [len][crc32][kind][payload]."""
    return _HEADER.pack(len(payload), zlib.crc32(payload), kind) + payload


class WAL:
    def __init__(self, path: str, sync: bool = False):
        self.path = path
        self.sync = sync
        self._f = open(path, "ab")
        # group-commit state: appended-entry tickets vs the highest ticket
        # a completed fsync covers. _cond also fences rotate() against an
        # in-flight leader fsync.
        self._cond = threading.Condition()
        self._seq = 0
        self._synced = 0
        self._syncing = False
        # the live log's byte backlog (the resource governor's write
        # watermark, utils/governor.py): bytes framed since the last
        # rotate, seeded from the size on disk so a reopened shard's
        # unflushed log counts against the budget
        try:
            self.backlog_bytes = os.path.getsize(path)
        except OSError:
            self.backlog_bytes = 0

    def _frame(self, kind: int, payload: bytes) -> int:
        """Write one entry; return its commit ticket (0 when sync is off).
        Appends are serialized by the owning shard's lock."""
        data = frame(kind, payload)
        if diskfault.armed():  # torn/flipped appends surface at replay
            data = diskfault.on_write(self.path, data,
                                      site="wal-append-write")
        self._f.write(data)
        self.backlog_bytes += len(data)
        _fp("wal-after-append")  # entry framed, not yet fsynced/acked
        if not self.sync:
            return 0
        with self._cond:
            self._seq += 1
            return self._seq

    def append_lines(self, lines: str | bytes, precision: str, now_ns: int) -> int:
        if isinstance(lines, str):
            lines = lines.encode("utf-8")
        prec = precision.encode("utf-8")
        if len(lines) >= _PLAIN_THRESHOLD:
            kind, body = _KIND_RAW_LINES_PLAIN, lines
        else:
            kind, body = _KIND_RAW_LINES, zlib.compress(lines, 1)
        payload = struct.pack("<BQ", len(prec), now_ns) + prec + body
        return self._frame(kind, payload)

    def append_points(self, points: list) -> int:
        """points: [(mst, tags tuple, t_ns, {field: (FieldType, value)})]."""
        doc = [
            [mst, [list(t) for t in tags], t_ns,
             {k: [int(ft), v] for k, (ft, v) in fields.items()}]
            for mst, tags, t_ns, fields in points
        ]
        payload = zlib.compress(json.dumps(doc).encode("utf-8"), 1)
        return self._frame(_KIND_POINTS, payload)

    def commit(self, ticket: int) -> None:
        """Block until the entry behind `ticket` is fsynced (no-op when
        sync is off). Call OUTSIDE the shard lock, so concurrent writers
        coalesce into one fsync."""
        if not self.sync or ticket <= 0:
            return
        while True:
            with self._cond:
                while True:
                    if self._synced >= ticket or ticket > self._seq:
                        # covered, or a ticket a replaced WAL minted (its
                        # close made it durable)
                        return
                    if not self._syncing:
                        self._syncing = True  # become the leader
                        solo = (self._seq == ticket
                                and self._synced == ticket - 1)
                        break
                    self._cond.wait()
            try:
                if not solo:
                    time.sleep(GROUP_COMMIT_S)  # gather followers
                with self._cond:
                    target = self._seq  # everything appended so far
                self._f.flush()
                _fp("wal-before-sync")  # once per fsync, not per append
                if diskfault.armed():
                    diskfault.on_fsync(self.path, site="wal-fsync")
                os.fsync(self._f.fileno())
                with self._cond:
                    self._synced = max(self._synced, target)
            finally:
                # on error: wake everyone; each retries as its own leader
                with self._cond:
                    self._syncing = False
                    self._cond.notify_all()

    def rotate(self, seg_path: str) -> str | None:
        """Freeze the live log: fsync it, rename to `seg_path`, start a
        fresh empty log. Returns seg_path, or None when the log held no
        entries. The caller (shard.flush) holds the shard lock."""
        with self._cond:
            while self._syncing:
                self._cond.wait()
            self._f.flush()
            try:
                if os.path.getsize(self.path) == 0:
                    return None
            except OSError:
                pass
            if diskfault.armed():
                diskfault.on_fsync(self.path, site="wal-fsync")
            os.fsync(self._f.fileno())
            self._f.close()
            _fp("wal-rotate-before-rename")  # fsynced, still the live log
            os.replace(self.path, seg_path)
            _fp("wal-rotate-after-rename")  # segment named, no live log yet
            self._f = open(self.path, "wb")
            self._synced = self._seq  # the segment fsync covered them all
            self.backlog_bytes = 0  # the frozen memtable carries them now
            return seg_path

    @staticmethod
    def segments(path: str) -> list[str]:
        """Rotated segment paths for the WAL at `path`, oldest first —
        present only after a crash between rotate and segment removal."""
        d = os.path.dirname(path) or "."
        base = os.path.basename(path) + "."
        try:
            names = os.listdir(d)
        except OSError:
            return []
        segs = [n for n in names
                if n.startswith(base) and n[len(base):].isdigit()]
        segs.sort(key=lambda n: int(n[len(base):]))
        return [os.path.join(d, n) for n in segs]

    def flush(self) -> None:
        with self._cond:
            while self._syncing:
                self._cond.wait()
            self._f.flush()
            if diskfault.armed():
                diskfault.on_fsync(self.path, site="wal-fsync")
            os.fsync(self._f.fileno())
            self._synced = self._seq

    def close(self) -> None:
        with self._cond:
            while self._syncing:
                self._cond.wait()
            self._f.close()
            self._synced = self._seq
            self._cond.notify_all()

    @staticmethod
    def _frame_at(data: bytes, off: int, strict: bool = False):
        """(kind, payload, end) when a valid frame starts at `off`, else
        None. At a positionally trusted offset validity is
        length-in-bounds + payload CRC (an unknown kind is a frame of a
        newer version, skipped by replay). `strict` is the salvage resync
        probe over arbitrary bytes: it also demands a known kind and a
        non-empty payload."""
        if off + _HEADER.size > len(data):
            return None
        length, crc, kind = _HEADER.unpack_from(data, off)
        if strict and (kind not in _KINDS or length == 0):
            return None
        start = off + _HEADER.size
        end = start + length
        if end > len(data):
            return None
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            return None
        return kind, payload, end

    @staticmethod
    def _scan(data: bytes):
        """Frame scan distinguishing torn tail from interior damage.
        Returns (clean, salvaged, corrupt_off): `clean` = [(kind,
        payload)] up to the first bad frame, `salvaged` = valid frames
        re-synced after it (empty = torn tail), `corrupt_off` = byte
        offset of the damage (None = log clean)."""
        clean: list = []
        off, n = 0, len(data)
        while off < n:
            got = WAL._frame_at(data, off)
            if got is None:
                break
            clean.append((got[0], got[1]))
            off = got[2]
        if off >= n:
            return clean, [], None
        corrupt_off = off
        salvaged: list = []
        pos = off + 1
        synced = False
        while pos + _HEADER.size <= n:
            got = WAL._frame_at(data, pos, strict=not synced)
            if got is None:
                synced = False
                pos += 1
                continue
            salvaged.append((got[0], got[1]))
            pos = got[2]
            synced = True
        return clean, salvaged, corrupt_off

    @staticmethod
    def _decode_entry(kind: int, payload: bytes):
        if kind in (_KIND_RAW_LINES, _KIND_RAW_LINES_PLAIN):
            plen, now_ns = struct.unpack_from("<BQ", payload)
            prec = payload[9:9 + plen].decode("utf-8")
            body = payload[9 + plen:]
            lines = (zlib.decompress(body) if kind == _KIND_RAW_LINES
                     else bytes(body))
            return ("lines", lines, prec, now_ns)
        doc = json.loads(zlib.decompress(payload))
        points = [
            (
                mst,
                tuple(tuple(t) for t in tags),
                t_ns,
                {k: (FieldType(ft), v) for k, (ft, v) in fields.items()},
            )
            for mst, tags, t_ns, fields in doc
        ]
        return ("points", points)

    @staticmethod
    def replay(path: str):
        """Yield ("lines", lines_bytes, precision, now_ns) and
        ("points", points) entries. A torn TAIL truncates silently; an
        INTERIOR bad frame raises WALCorruption after yielding the clean
        prefix."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        if diskfault.armed():
            data = diskfault.on_read(path, data, site="wal-replay-read")
        clean, salvaged, corrupt_off = WAL._scan(data)
        for kind, payload in clean:
            if kind in _KINDS:  # forward compat: skip newer-version kinds
                yield WAL._decode_entry(kind, payload)
        if corrupt_off is None or not salvaged:
            return  # clean, or a torn tail: nothing acked lives past it
        raise WALCorruption(path, corrupt_off, clean, salvaged)
