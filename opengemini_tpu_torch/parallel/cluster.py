"""Multi-node data plane: shard-group placement, write routing, remote
scans.

The port of ``opengemini_tpu/parallel/cluster.py``, whole, with plain
``threading`` locks: placement, routed writes, hinted handoff, remote
scans, and the cluster operations (load balancing, forced moves, node
add, drain and decommission, the two-phase migration, anti-entropy);
strict data replication hooks in through ``datarep``
(parallel/datarep.py). Every body and file (the points, hints, scan
payloads, migration phases, digests and health views) is the JAX
package's, so a port node and a JAX node serve, migrate to and repair
each other. Beyond the reference, the same rows reach the same engines
faster: a write's local slice and a replica's /internal/write go to the
engine as one columnar batch where ``write_points`` can, a write's
group owners are computed once per group, and a migration pushes
nothing to a retained owner whose copy has the source's digest
(``_lacking``).

Reference: coordinator/points_writer.go (MapShards + WritePointRows shard
routing) and the coordinator select exchange (remote readers feeding the
executor). The TPU-first data plane has two tiers: mergeable aggregates
push down — each peer computes dense per-(group, window) partials on its
own slice (query/partials.py) and ships O(groups x windows) arrays — and
everything else falls back to peers SERVING raw columns over
/internal/scan with aggregation on the coordinating node's device.

Placement is rendezvous (HRW) hashing over the registered data nodes:
stable under node add/remove (only ~1/N of groups move), no ring state
to replicate.
"""

from __future__ import annotations

import hashlib
import json
import threading
import urllib.error
import urllib.parse
import urllib.request

from opengemini_tpu_torch.parallel import netfault
from opengemini_tpu_torch.utils import peers

import numpy as np

from opengemini_tpu_torch.index.inverted import SeriesIndex
from opengemini_tpu_torch.record import Column, FieldType, Record
from opengemini_tpu_torch.utils import tracing
from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.failpoint import inject as _fp
from opengemini_tpu_torch.utils.governor import _env_float, _env_int
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS
from opengemini_tpu_torch.utils.stats import observe_ns as _observe_ns

# a peer's cached health view older than this cannot vote in the quorum
# failure view (its probe loop stalled or has not run yet)
_MAX_VIEW_AGE_S = 90.0


class CircuitOpen(OSError):
    """Fast-failed by the per-node circuit breaker (peer is suspect)."""


class CircuitBreaker:
    """Per-peer consecutive-transport-failure breaker (the gossip
    suspicion state machine's RPC-side analogue): after `threshold`
    consecutive failures the peer is SUSPECT and every RPC to it fails
    fast (CircuitOpen, an OSError — callers classify it exactly like an
    unreachable node) instead of burning a full connect timeout per
    call.  After `cooldown_s` ONE half-open trial RPC is let through:
    success closes the breaker, failure re-opens it for a fresh
    cooldown.

    Pass-through when disabled (threshold <= 0, the default): allow()
    is one comparison, record() a no-op — bit-identical to an
    unwrapped transport (asserted by tests/test_netfault.py)."""

    def __init__(self, threshold: int = 0, cooldown_s: float = 5.0):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._lock = lockdep.Lock()
        # peer key -> [consecutive failures, opened-at walltime,
        #              half-open trial in flight]
        self._peers: dict[str, list] = {}

    def enabled(self) -> bool:
        return self.threshold > 0

    def allow(self, key: str) -> bool:
        """May an RPC to `key` proceed?  False = fail fast (open, and
        either cooling down or a half-open trial is already out)."""
        if self.threshold <= 0:
            return True
        import time as _t

        with self._lock:
            st = self._peers.get(key)
            if st is None or st[0] < self.threshold:
                return True
            if st[2]:
                return False  # one half-open probe at a time
            if _t.perf_counter() - st[1] >= self.cooldown_s:
                st[2] = True  # this caller becomes the trial probe
                return True
            return False

    def record(self, key: str, ok: bool) -> None:
        """Outcome of an RPC to `key`.  An HTTP status error counts as
        OK here — the peer answered, the circuit is about transport
        reachability, not application health."""
        if self.threshold <= 0:
            return
        import time as _t

        with self._lock:
            st = self._peers.setdefault(key, [0, 0.0, False])
            st[2] = False
            if ok:
                st[0] = 0
            else:
                st[0] += 1
                if st[0] >= self.threshold:
                    st[1] = _t.perf_counter()  # (re)open: fresh cooldown

    def state(self, key: str) -> str:
        if self.threshold <= 0:
            return "closed"
        import time as _t

        with self._lock:
            st = self._peers.get(key)
            if st is None or st[0] < self.threshold:
                return "closed"
            if st[2] or _t.perf_counter() - st[1] >= self.cooldown_s:
                return "half-open"
            return "open"

    def is_open(self, key: str) -> bool:
        """Suspect right now (open or mid-trial)?  Feeds node_up() so
        the quorum failure view sees breaker-detected deaths between
        probe ticks."""
        if self.threshold <= 0:
            return False
        with self._lock:
            st = self._peers.get(key)
            return st is not None and st[0] >= self.threshold

    def snapshot(self) -> dict:
        with self._lock:
            peers_ = {k: {"failures": st[0]} for k, st in self._peers.items()
                      if st[0] > 0}
        for k in peers_:
            peers_[k]["state"] = self.state(k)
        return {"threshold": self.threshold, "cooldown_s": self.cooldown_s,
                "peers": peers_}


def owners(nodes: list[str], db: str, rp: str, group_start: int,
           rf: int = 1) -> list[str]:
    """Rendezvous hash: the rf nodes with the highest keyed digests own
    the shard group, primary first (deterministic on every node, no
    coordination; node add/remove moves ~1/N of groups)."""
    scored = []
    for n in sorted(nodes):
        h = hashlib.blake2b(
            f"{n}|{db}|{rp}|{group_start}".encode(), digest_size=8
        ).digest()
        scored.append((int.from_bytes(h, "big"), n))
    scored.sort(reverse=True)
    return [n for _s, n in scored[: max(1, rf)]]


def owner(nodes: list[str], db: str, rp: str, group_start: int) -> str:
    return owners(nodes, db, rp, group_start, 1)[0]


def write_points(engine, db: str, points: list, rp: str | None = None
                 ) -> int:
    """Write structured points into the local engine: as one columnar
    batch (Engine.write_batch) where ingest/native_lp.points_batch takes
    them, else through Engine.write_rows (string fields, non-finite
    floats, keys that do not read back). The rows stored are the same."""
    from opengemini_tpu_torch.ingest.native_lp import points_batch

    batch = points_batch(points) if len(points) > 1 else None
    if batch is None:
        return engine.write_rows(db, points, rp=rp)
    return engine.write_batch(db, batch, rp=rp)


_TYPE_NAME = {ft: ft.name for ft in FieldType}
_TYPE_OF = {ft.name: ft for ft in FieldType}


def encode_points(points: list) -> list:
    """Structured points -> JSON-able wire shape (single definition:
    forward_points, hints, and /internal/write all share it). A series'
    tag list is built once and shared by its points (the JSON is the
    same)."""
    tag_lists: dict = {}
    out = []
    for mst, tags, t, fields in points:
        tl = tag_lists.get(tags)
        if tl is None:
            tl = tag_lists[tags] = list(map(list, tags))
        out.append([mst, tl, int(t),
                    {name: [_TYPE_NAME[ft], v]
                     for name, (ft, v) in fields.items()}])
    return out


def decode_points(doc: list) -> list:
    return [
        (mst, tuple(tuple(t) for t in tags), int(t_ns),
         {name: (_TYPE_OF[ft], v) for name, (ft, v) in fields.items()})
        for mst, tags, t_ns, fields in doc
    ]


class RemoteScanError(Exception):
    """A data node required for a complete answer was unreachable."""


class PartialsRetry(Exception):
    """A peer died between the metadata round and the partial-aggregate
    round: the caller must rebuild its plan against a fresh live set
    (primary assignment shifted) and retry the whole statement."""


class PartialsUnavailable(Exception):
    """A live peer answered the partial round with an HTTP error (e.g. a
    not-yet-upgraded node 404ing the endpoint): the caller should fall
    back to the raw column exchange instead of retrying or failing."""


class _NodeDown(Exception):
    """Internal: one specific peer failed (drives replica failover)."""

    def __init__(self, nid: str, msg: str):
        super().__init__(msg)
        self.nid = nid


class _RemoteMem:
    """Memtable stand-in: carries the remote data range so the executor's
    data-driven range clamp sees remote extents; never holds rows."""

    def __init__(self, min_time, max_time):
        self.min_time = min_time
        self.max_time = max_time

    def record_for(self, sid):
        return None


class RemoteShard:
    """In-memory shard proxy built from a peer's /internal/scan response.

    Duck-types the slice of the Shard surface the query paths touch
    (index / schema / read_series / measurements / file_chunks / mem);
    the pre-aggregation fast path is disabled for remote data
    (supports_preagg) because chunk metadata never leaves the owner.
    """

    supports_preagg = False

    def __init__(self, mst: str, payload: dict):
        self.index = SeriesIndex()  # in-memory
        self._mst = mst
        self._schema: dict[str, FieldType] = {
            name: FieldType[t] for name, t in payload.get("schema", {}).items()
        }
        self._records: dict[int, Record] = {}
        tmin = tmax = None
        for s in payload.get("series", []):
            tags = tuple((k, v) for k, v in sorted(s["tags"].items()))
            sid = self.index.get_or_create(mst, tags)
            times = np.asarray(s["times"], dtype=np.int64)
            cols = {}
            for name, col in s.get("fields", {}).items():
                ftype = FieldType[col["type"]]
                if ftype == FieldType.STRING:
                    values = np.asarray(col["values"], dtype=object)
                elif ftype == FieldType.INT:
                    values = np.asarray(col["values"], dtype=np.int64)
                elif ftype == FieldType.BOOL:
                    values = np.asarray(col["values"], dtype=bool)
                else:
                    values = np.asarray(col["values"], dtype=np.float64)
                valid = np.asarray(col["valid"], dtype=bool)
                cols[name] = Column(ftype, values, valid)
            self._records[sid] = Record(times, cols)
            if len(times):
                t0, t1 = int(times[0]), int(times[-1])
                tmin = t0 if tmin is None else min(tmin, t0)
                tmax = t1 if tmax is None else max(tmax, t1)
        self.tmin = tmin if tmin is not None else 0
        self.tmax = (tmax + 1) if tmax is not None else 0
        self.mem = _RemoteMem(tmin, tmax)

    def measurements(self):
        return [self._mst] if self._records else []

    def schema(self, mst):
        return dict(self._schema) if mst == self._mst else {}

    def file_chunks(self, mst, sids=None, tmin=None, tmax=None):
        return []

    def read_series(self, mst, sid, tmin=None, tmax=None, fields=None):
        rec = self._records.get(sid)
        if rec is None or mst != self._mst:
            return Record.empty()
        times = rec.times
        lo = 0 if tmin is None else int(np.searchsorted(times, tmin, "left"))
        hi = len(times) if tmax is None else int(np.searchsorted(times, tmax, "left"))
        cols = {
            k: Column(c.ftype, c.values[lo:hi], c.valid[lo:hi])
            for k, c in rec.columns.items()
            if fields is None or k in fields
        }
        return Record(times[lo:hi], cols)


class _MetaIndex(SeriesIndex):
    """Empty index that still reports the remote measurement's tag keys
    (GROUP BY * and WHERE classification need them); every posting lookup
    legitimately returns nothing — remote series are represented by the
    partial arrays, not by local sids."""

    def __init__(self, tag_keys_by_mst: dict):
        super().__init__()
        self._tk = tag_keys_by_mst

    def tag_keys(self, mst):
        return set(self._tk.get(mst, ()))


class MetaShard:
    """Metadata-only stand-in for remote data during aggregate pushdown
    (reference: the shard-mapper prepare round that fetches schema/tag
    metadata before store-side execution). Contributes tag keys, field
    schema, and the data time extent to scan planning; owns no rows."""

    supports_preagg = False

    def __init__(self, mst: str, tag_keys: set, schema: dict,
                 dmin: int, dmax: int):
        self._mst = mst
        self.index = _MetaIndex({mst: set(tag_keys)})
        self._schema = {n: FieldType[t] for n, t in schema.items()}
        self.tmin = dmin
        self.tmax = dmax + 1
        self.mem = _RemoteMem(dmin, dmax)

    def measurements(self):
        return [self._mst]

    def schema(self, mst):
        return dict(self._schema) if mst == self._mst else {}

    def file_chunks(self, mst, sids=None, tmin=None, tmax=None):
        return []

    def read_series(self, mst, sid, tmin=None, tmax=None, fields=None):
        return Record.empty()


def _as_list(xs):
    return xs.tolist() if hasattr(xs, "tolist") else xs


def payload_to_points(mst: str, payload: dict) -> list:
    """/internal/scan payload -> engine points (structured write shape)."""
    from opengemini_tpu_torch.record import FieldType

    points = []
    for s in payload.get("series", []):
        tags = tuple(sorted(s["tags"].items()))
        times = s["times"]
        per_field = []
        for name, col in s["fields"].items():
            ftype = FieldType[col["type"]] if isinstance(col["type"], str) \
                else FieldType(col["type"])
            # the binary wire's arrays as Python scalars, as .item() gives
            per_field.append((name, ftype, _as_list(col["values"]),
                              _as_list(col["valid"])))
        for i, t in enumerate(_as_list(times)):
            fields = {name: (ftype, values[i])
                      for name, ftype, values, valid in per_field
                      if valid[i]}
            if fields:
                points.append((mst, tags, int(t), fields))
    return points


def serialize_select_meta(engine, db, rp, mst, tmin, tmax,
                          shard_filter=None) -> dict:
    """Peer side of the pushdown metadata round: tag keys, schema, and
    data extent of `mst` within the range on THIS node."""
    shards = engine.shards_for_range(db, rp, tmin, tmax)
    if shard_filter is not None:
        shards = [sh for sh in shards if shard_filter(sh)]
    tag_keys: set[str] = set()
    schema: dict[str, str] = {}
    dmin = dmax = None
    for sh in shards:
        tag_keys.update(sh.index.tag_keys(mst))
        for name, ftype in sh.schema(mst).items():
            schema.setdefault(name, ftype.name)
        for r, c in sh.file_chunks(mst):
            dmin = c.tmin if dmin is None else min(dmin, c.tmin)
            dmax = c.tmax if dmax is None else max(dmax, c.tmax)
        # frozen flush snapshots count as in-memory rows too (lazy
        # import: qhelpers imports this module at load time)
        from opengemini_tpu_torch.query.qhelpers import _shard_mem_time_range

        m_lo, m_hi = _shard_mem_time_range(sh)
        if m_lo is not None:
            dmin = m_lo if dmin is None else min(dmin, m_lo)
            dmax = m_hi if dmax is None else max(dmax, m_hi)
    return {"tag_keys": sorted(tag_keys), "schema": schema,
            "dmin": dmin, "dmax": dmax}


# explicit little-endian wire dtypes: a big-endian peer must not emit
# native-order buffers a little-endian coordinator misreads
_BIN_DTYPES = {"FLOAT": "<f8", "INT": "<i8", "BOOL": "u1"}
_PAD_DTYPES = {"FLOAT": np.float64, "INT": np.int64, "BOOL": bool}


def _bulk_series(sh, mst, sids, tmin, tmax):
    """[(sid, times, {field: (values, valid)})] of the series with rows
    in range, from one bulk read of the shard, where that equals reading
    each series alone: 64 series or more, no in-memory rows in range, and
    every chunk in range with the same fields (a series' own read carries
    the fields of its chunks, a bulk read those of them all). None
    otherwise: the caller reads each series (a per-series read decodes a
    packed chunk once per series it holds)."""
    from opengemini_tpu_torch.query.qhelpers import _shard_mem_time_range

    if len(sids) < 64 or not hasattr(sh, "read_series_bulk"):
        return None
    lo, hi = _shard_mem_time_range(sh)
    if lo is not None and lo < tmax and hi >= tmin:
        return None
    chunks = sh.file_chunks(mst, None, tmin, tmax)
    if len({frozenset(c.cols) for _r, c in chunks}) != 1:
        return None
    sid_arr, rec = sh.read_series_bulk(mst, np.asarray(sids, np.int64),
                                       tmin, tmax)
    if not len(rec):
        return []
    cols = {n: (c.values, c.valid) for n, c in rec.columns.items()}
    cut = np.flatnonzero(np.diff(sid_arr)) + 1
    starts = [0, *cut.tolist()]
    ends = [*cut.tolist(), len(sid_arr)]
    return [(int(sid_arr[a]), rec.times[a:b],
             {n: (v[a:b], m[a:b]) for n, (v, m) in cols.items()})
            for a, b in zip(starts, ends)]


def _collect_series(engine, db, rp, mst, tmin, tmax, shard_filter=None):
    """Shared scan collector: (schema, [{tags, times(ndarray),
    fields: {name: (type, values(ndarray), valid(ndarray))}}]) — column
    arrays stay numpy end to end (no per-value Python boxing); invalid
    slots are zeroed so neither wire format leaks stale memory."""
    shards = engine.shards_for_range(db, rp, tmin, tmax)
    if shard_filter is not None:
        shards = [sh for sh in shards if shard_filter(sh)]
    schema: dict[str, str] = {}
    by_key: dict[tuple, dict] = {}
    rows = 0
    with tracing.current().span("scan") as _sp:
        for sh in sorted(shards, key=lambda s: s.tmin):
            for name, ftype in sh.schema(mst).items():
                schema.setdefault(name, ftype.name)
            sids = sorted(sh.index.series_ids(mst))
            got = _bulk_series(sh, mst, sids, tmin, tmax)
            if got is None:
                got = []
                for sid in sids:
                    rec = sh.read_series(mst, sid, tmin, tmax)
                    if len(rec):
                        got.append((sid, rec.times,
                                    {n: (c.values, c.valid)
                                     for n, c in rec.columns.items()}))
            for sid, times, cols in got:
                rows += len(times)
                tags = sh.index.tags_of(sid)
                key = tuple(sorted(tags.items()))
                entry = by_key.setdefault(
                    key, {"tags": dict(tags), "chunks": []}
                )
                entry["chunks"].append((times, cols))
        _sp.add_field("rows", rows)
        _sp.add_field("series", len(by_key))
    out = []
    for entry in by_key.values():
        chunks = entry["chunks"]
        times = np.concatenate([c[0] for c in chunks])
        fnames = sorted({n for _t, cols in chunks for n in cols})
        fields = {}
        for name in fnames:
            ftype = schema.get(name, "FLOAT")
            pad_dt = _PAD_DTYPES.get(ftype, object)
            parts_v, parts_m = [], []
            for c_times, cols in chunks:
                got = cols.get(name)
                if got is None:  # field absent from this shard's chunk
                    parts_v.append(np.zeros(len(c_times), pad_dt))
                    parts_m.append(np.zeros(len(c_times), bool))
                else:
                    parts_v.append(got[0])
                    parts_m.append(got[1])
            values = np.concatenate(parts_v)
            valid = np.concatenate(parts_m).astype(bool)
            if ftype == "STRING":
                values = np.asarray(
                    [v if b else 0 for v, b in zip(values, valid)], object
                )
            else:
                values = np.where(valid, values, 0)
            fields[name] = (ftype, values, valid)
        out.append({"tags": entry["tags"], "times": times, "fields": fields})
    return schema, out


def serialize_series(engine, db, rp, mst, tmin, tmax,
                     shard_filter=None, trace_ctx=None,
                     node: str = "") -> dict:
    """JSON /internal/scan body (fallback wire format): every series of
    `mst` in range, merged across local shards. `shard_filter(shard)`
    restricts to groups this node is PRIMARY for (rf>1 reads)."""
    t, cm = tracing.start_remote_activated("internal_scan", trace_ctx,
                                           node=node)
    with cm:
        schema, series = _collect_series(engine, db, rp, mst, tmin, tmax,
                                         shard_filter)
    out = []
    for s in series:
        fields = {}
        for name, (ftype, values, valid) in s["fields"].items():
            fields[name] = {"type": ftype, "values": values.tolist(),
                            "valid": valid.tolist()}
        out.append({"tags": s["tags"], "times": s["times"].tolist(),
                    "fields": fields})
    doc = {"schema": schema, "series": out}
    sub = tracing.ship_subtree(t)
    if sub is not None:
        doc["trace"] = sub
    return doc


def serialize_series_binary(engine, db, rp, mst, tmin, tmax,
                            shard_filter=None, trace_ctx=None,
                            node: str = "") -> bytes:
    """Binary /internal/scan payload: [u32 header_len][header JSON]
    [raw column buffers]. Numeric columns and times travel as raw
    LITTLE-ENDIAN ndarrays (memcpy in, frombuffer out) instead of JSON
    number lists — the data-plane wire bottleneck. String columns stay
    JSON inside the header (rare, variable-width)."""
    import struct as _struct

    t, cm = tracing.start_remote_activated("internal_scan", trace_ctx,
                                           node=node)
    with cm:
        schema, series = _collect_series(engine, db, rp, mst, tmin, tmax,
                                         shard_filter)
    buffers: list[bytes] = []
    off = 0

    def _add(arr: np.ndarray, dtype: str) -> list[int]:
        nonlocal off
        b = np.ascontiguousarray(arr.astype(dtype, copy=False)).tobytes()
        buffers.append(b)
        loc = [off, len(b)]
        off += len(b)
        return loc

    header = {"schema": schema, "series": []}
    for s in series:
        entry = {"tags": s["tags"],
                 "times": _add(s["times"], "<i8"), "fields": {}}
        for name, (ftype, values, valid) in s["fields"].items():
            f = {"type": ftype, "valid": _add(valid, "u1")}
            dt = _BIN_DTYPES.get(ftype)
            if dt is not None:
                f["values"] = _add(values, dt)
            else:  # STRING: JSON in the header
                f["strings"] = values.tolist()
            entry["fields"][name] = f
        header["series"].append(entry)
    sub = tracing.ship_subtree(t)
    if sub is not None:
        header["trace"] = sub
    hbuf = json.dumps(header, separators=(",", ":")).encode()
    return _struct.pack("<I", len(hbuf)) + hbuf + b"".join(buffers)


def parse_series_binary(data: bytes) -> dict:
    """Inverse of serialize_series_binary -> the JSON-shaped doc
    RemoteShard consumes (arrays stay numpy, no per-value boxing)."""
    import struct as _struct

    (hlen,) = _struct.unpack_from("<I", data, 0)
    header = json.loads(data[4 : 4 + hlen])
    base = 4 + hlen
    payload = memoryview(data)[base:]

    def _arr(loc, dtype):
        o, ln = loc
        return np.frombuffer(payload[o : o + ln], dtype=dtype)

    out = {"schema": header["schema"], "series": []}
    if "trace" in header:
        out["trace"] = header["trace"]
    for s in header["series"]:
        fields = {}
        for name, f in s["fields"].items():
            t = f["type"]
            valid = _arr(f["valid"], "u1").astype(bool)
            if "values" in f:
                values = _arr(f["values"], _BIN_DTYPES[t])
                if t == "BOOL":
                    values = values.astype(bool)
            else:
                values = f["strings"]
            fields[name] = {"type": t, "values": values, "valid": valid}
        out["series"].append({
            "tags": s["tags"],
            "times": _arr(s["times"], "<i8"),
            "fields": fields,
        })
    return out


class DataRouter:
    """Coordinator-side routing: which node owns a shard group, forward
    writes there, and pull raw columns back for queries."""

    def __init__(self, engine, meta_store, self_id: str, self_addr: str,
                 token: str = "", timeout_s: float = 10.0, rf: int = 1,
                 write_consistency: str = "one"):
        self.engine = engine
        self.meta_store = meta_store
        self.self_id = self_id
        self.self_addr = self_addr
        self.token = token
        self.timeout_s = timeout_s
        # replication factor: every shard group lives on the rf top
        # rendezvous owners; reads are primary-filtered so replicas never
        # double-count (HA ops analogue of the reference's replication)
        self.rf = max(1, rf)
        # rf>1 write acknowledgment level (reference: the consistency-mode
        # choice its HA policies give operators; influx /write
        # consistency=any|one|quorum|all): how many synchronous owner
        # copies each point needs before the write ACKs — the rest ride
        # hinted handoff. "all" is the strict mode: every replica
        # synchronously or the write errors.
        if write_consistency not in ("any", "one", "quorum", "all"):
            raise ValueError(
                f"bad write consistency {write_consistency!r}")
        self.write_consistency = write_consistency
        # strict replication (parallel/datarep.DataReplication) under the
        # "replication" HA policy; None is the write-available default
        self.datarep = None
        # RPC hardening knobs (cluster torture forces all of these):
        # liveness-probe timeout (was hardcoded 2s), transient-retry
        # count + jittered exponential backoff base for data-plane
        # RPCs, and the per-node circuit breaker (off by default —
        # bit-identical pass-through, like the netfault transport)
        self.probe_timeout_s = _env_float("OGT_PROBE_TIMEOUT_S", 2.0)
        self.rpc_retries = max(0, _env_int("OGT_RPC_RETRIES", 0))
        self.rpc_backoff_ms = _env_float("OGT_RPC_BACKOFF_MS", 50.0)
        self.breaker = CircuitBreaker(
            threshold=_env_int("OGT_CB_THRESHOLD", 0),
            cooldown_s=_env_float("OGT_CB_COOLDOWN_S", 5.0))
        self._hint_lock = lockdep.Lock()
        # last health-probe results: node id -> bool (True = reachable)
        self.health: dict[str, bool] = {}
        self.health_ts: float = 0.0  # walltime of the last local probe
        # quorum-aggregated failure view (gossip equivalent): node id ->
        # bool agreed by a majority of live observers; plus first-seen-down
        # walltime for failover grace decisions
        self.shared_health: dict[str, bool] = {}
        self.down_since: dict[str, float] = {}
        # elastic-membership introspection (POST /debug/ctrl?mod=cluster
        # op=decommission|drain): last drain/decommission progress doc
        self.decommission_state: dict = {"phase": "idle"}

    def probe_health(self) -> dict[str, bool]:
        """Ping every registered data node (reference: the cluster
        manager's member health checks); results land in self.health and
        surface through SHOW CLUSTER."""
        def probe(nid, addr):
            if not addr:
                return (nid, False)
            try:
                netfault.check(self.self_id, "/ping", nid, addr)
                with peers.urlopen(peers.url(addr, "/ping"),
                                   timeout=self.probe_timeout_s) as r:
                    ok = r.status in (200, 204)
            except urllib.error.HTTPError:
                # the peer ANSWERED (just not 2xx): unhealthy for the
                # probe, but transport-reachable for the breaker —
                # mirrors _post_raw's taxonomy
                self.breaker.record(addr, True)
                return (nid, False)
            except OSError:
                self.breaker.record(addr, False)
                return (nid, False)
            # a completed probe round-trip is transport evidence either
            # way; probes bypass allow() so they remain the breaker's
            # half-open recovery signal even while it is open
            self.breaker.record(addr, True)
            return (nid, ok)

        import time as _t

        results = dict(self._fanout(probe))
        results[self.self_id] = True
        self.health = results
        self.health_ts = _t.time()  # wall stamp; 0.0 until the first probe
        return results

    def exchange_health(self) -> dict[str, bool]:
        """Shared failure view: probe locally, then exchange views with
        reachable peers and agree by majority (the serf-gossip equivalent,
        reference app/ts-meta/meta/cluster_manager.go:323 checkFailedNode;
        SWIM-style indirect observation without the gossip protocol — the
        membership roster is already raft-replicated, only liveness needs
        agreement).

        A node counts DOWN only when >half of the live observers (self +
        peers whose view we could fetch) say so — one coordinator with a
        broken route cannot wrongly demote a healthy replica, and one
        flaky link cannot flap SHOW CLUSTER for everyone."""
        import time as _t

        local = dict(self.probe_health())
        now = _t.time()  # down_since display stamp

        def fetch(nid, addr):
            # fetch from EVERY peer, including ones our local probe lost:
            # a reachable view from a "down" peer is the SWIM-style
            # refutation (our route is broken, the node is fine)
            if not addr:
                return None
            req = urllib.request.Request(
                peers.url(addr, "/cluster/health"),
                headers={"X-Ogt-Token": self.token},
            )
            try:
                netfault.check(self.self_id, "/cluster/health", nid, addr)
                with peers.urlopen(req, timeout=self.probe_timeout_s) as r:
                    got = json.loads(r.read())
                view = got.get("health")
                if isinstance(view, dict):
                    age = got.get("age_s")
                    return (nid, {str(k): bool(v) for k, v in view.items()},
                            float(age) if age is not None else None)
            except (OSError, ValueError, TypeError):
                pass
            return None

        views: dict[str, dict[str, bool]] = {}
        for got in self._fanout(fetch):
            if got is None:
                continue
            nid, view, age = got
            # completing an HTTP round-trip to nid IS liveness evidence —
            # it corrects a stale/failed local ping before the tally (the
            # 2-node tie case: our broken route must not outvote the
            # refutation we just received)
            local[nid] = True
            if age is not None and age <= _MAX_VIEW_AGE_S:
                # stale cached views (peer's probe loop stalled or hasn't
                # run yet) don't get to outvote fresh observations; the
                # age is peer-relative so clock skew cannot disqualify it
                views[nid] = view
        views[self.self_id] = local
        agreed: dict[str, bool] = {}
        for nid in self.data_nodes():
            votes = [v[nid] for v in views.values() if nid in v]
            up = sum(votes) * 2 >= len(votes) if votes else local.get(nid, False)
            agreed[nid] = up
        agreed[self.self_id] = True
        for nid, up in agreed.items():
            if up:
                self.down_since.pop(nid, None)
            else:
                self.down_since.setdefault(nid, now)
        # roster changes: drop grace timestamps for decommissioned nodes so
        # a later re-join with the same id starts a fresh grace window
        for nid in list(self.down_since):
            if nid not in agreed:
                del self.down_since[nid]
        self.shared_health = agreed
        return agreed

    def node_up(self, nid: str) -> bool:
        """Best failure signal available: the quorum view when one has
        been computed, else the local probe, defaulting optimistic (an
        unknown node is treated reachable so writes try it and hint on
        failure rather than silently skipping).  An OPEN circuit
        breaker overrides both — K consecutive transport failures is
        fresher evidence than the last probe tick, and gating here
        keeps migrations/anti-entropy off a node the breaker is
        fast-failing anyway."""
        if nid != self.self_id and self.breaker.enabled():
            addr = self.data_nodes().get(nid, "")
            if addr and self.breaker.is_open(addr):
                return False
        if nid in self.shared_health:
            return self.shared_health[nid]
        return self.health.get(nid, True)

    def data_nodes(self) -> dict[str, str]:
        nodes = {
            nid: info.get("addr", "")
            for nid, info in self.meta_store.fsm.nodes.items()
            if info.get("role") == "data"
        }
        nodes.setdefault(self.self_id, self.self_addr)
        return nodes

    def group_owners(self, db: str, rp_name: str, group_start: int,
                     rf: int | None = None,
                     nodes: list[str] | None = None) -> list[str]:
        """Owner list for one shard group: a load-balancer placement
        override from the meta FSM wins (filtered to nodes that still
        exist — a removed node must not black-hole a group), else
        rendezvous. Reference: balance_manager.go moving ownership away
        from hot nodes."""
        ids = sorted(self.data_nodes()) if nodes is None else nodes
        over = getattr(self.meta_store.fsm, "placement", None)
        if over:
            got = over.get(f"{db}|{rp_name}|{group_start}")
            if got:
                live_set = set(ids)
                kept = [n for n in got if n in live_set]
                if kept:
                    return kept[: max(1, rf or self.rf)]
        return owners(ids, db, rp_name, group_start, rf or self.rf)

    def _group_start(self, db: str, rp: str | None, t_ns: int) -> int:
        from opengemini_tpu_torch.storage.engine import DatabaseNotFound, WriteError

        d = self.engine.databases.get(db)
        if d is None:
            raise DatabaseNotFound(db)
        rp_meta = d.rps.get(rp or d.default_rp)
        if rp_meta is None:
            raise WriteError(f"retention policy not found: {db}.{rp}")
        from opengemini_tpu_torch.storage.engine import shard_group_start

        return shard_group_start(t_ns, rp_meta.shard_duration_ns)

    def _owners_memo(self, db: str, rp, rp_name: str, ids: list):
        """t_ns -> the owners of its shard group, each group's owners
        computed once per call (a write's points share few groups)."""
        memo: dict[int, list] = {}

        def dest_of(t_ns: int) -> list:
            gs = self._group_start(db, rp, t_ns)
            got = memo.get(gs)
            if got is None:
                got = memo[gs] = self.group_owners(db, rp_name, gs,
                                                   nodes=ids)
            return got

        return dest_of

    def split_points(self, db: str, rp: str | None, points: list):
        """points -> (local, {node_id: [points]}): every point goes to ALL
        rf owners of its shard group (replicas get their own copy)."""
        from opengemini_tpu_torch.storage.engine import DatabaseNotFound

        d = self.engine.databases.get(db)
        if d is None:
            raise DatabaseNotFound(db)
        rp_name = rp or d.default_rp
        ids = sorted(self.data_nodes())
        local, remote = [], {}
        dest_of = self._owners_memo(db, rp, rp_name, ids)
        for p in points:
            dest = dest_of(p[2])
            for o in dest:
                if o == self.self_id:
                    local.append(p)
                else:
                    remote.setdefault(o, []).append(p)
        return local, remote

    def is_primary(self, db: str, rp: str | None, group_start: int,
                   live: list[str]) -> bool:
        """Is this node the group's PRIMARY among `live` owners? Reads
        with rf>1 include each group exactly once via this filter."""
        d = self.engine.databases.get(db)
        rp_name = rp or (d.default_rp if d else "autogen")
        got = self.group_owners(db, rp_name, group_start, rf=1,
                                nodes=sorted(live))
        return got[0] == self.self_id

    def routed_write(self, db: str, rp: str | None, points: list,
                     consistency: str | None = None) -> int:
        """The one coordinator-write sequence (used by HTTP /write and
        SELECT INTO): split by owner, write the local slice structurally,
        forward the rest as STRUCTURED JSON — line-protocol text cannot
        carry arbitrary content (e.g. newlines in string fields).

        rf>1 acknowledges at the configured consistency level (reference:
        the HA-policy consistency choice; influx consistency=any|one|
        quorum|all): each point needs that many SYNCHRONOUS owner copies
        before the write ACKs; copies for unreachable replicas queue as
        hints and replay when the node returns. "all" is the strict mode
        — every replica synchronously or the write errors, nothing is
        hinted. Reads stay correct at every level because failover makes
        a LIVE owner primary — and a live owner holds its synchronous
        copy. rf=1 keeps all-or-error: there is no second copy to lean
        on."""
        level = consistency or self.write_consistency
        if level not in ("any", "one", "quorum", "all"):
            raise ValueError(f"bad consistency level {level!r}")
        if self.datarep is not None:
            # strict replication: every batch commits through its owner
            # set's raft group before the answer (parallel/datarep.py);
            # the raft majority takes the place of the consistency level
            return self.datarep.write(db, rp, points)
        local, remote = self.split_points(db, rp, points)
        n = 0
        if local:
            n += write_points(self.engine, db, local, rp)
        import urllib.error

        failed: list[tuple[str, list, Exception]] = []
        for node_id, pts in sorted(remote.items()):
            _fp("cluster-write-before-forward")  # per-replica fan-out edge
            try:
                self.forward_points(node_id, db, rp, pts)
                n += len(pts)
            except urllib.error.HTTPError as e:
                if e.code == 400:
                    # the replica deterministically rejected the payload
                    # (unparseable points): hinting would retry forever —
                    # surface it as a hard failure instead
                    raise RemoteScanError(
                        f"replica {node_id!r} rejected write: {e}"
                    ) from e
                # 429 write backpressure, 403 during a cluster-token
                # rotation, 5xx: transient — count the replica as
                # unreachable so the copy rides the hint queue and the
                # consistency-level accounting (same classification as
                # replay_hints), instead of failing the whole batch hard
                failed.append((node_id, pts, e))
            except (OSError, RemoteScanError) as e:
                failed.append((node_id, pts, e))
        if failed:
            if level == "any" and self.rf > 1:
                # influx 'any': the durable local hint queue IS the ack —
                # accept even when no owner was synchronously reachable
                for node_id, pts, _e in failed:
                    _fp("cluster-write-before-hint")
                    self.hint(node_id, db, rp, pts)
                    n += len(pts)
                return n
            need = {
                "one": 1,
                "quorum": self.rf // 2 + 1,
                "all": self.rf,
            }.get(level, 1)
            if self.rf <= 1 or not self._covered(db, rp, points, failed,
                                                 need):
                raise RemoteScanError(
                    f"write failed at consistency={level}: {failed[0][2]}"
                ) from failed[0][2]
            for node_id, pts, _e in failed:
                _fp("cluster-write-before-hint")
                self.hint(node_id, db, rp, pts)
                n += len(pts)
        return n

    def _covered(self, db, rp, points, failed, need: int) -> bool:
        """Did every point land on at least `need` owners? (failed
        targets excluded)."""
        dead = {nid for nid, _pts, _e in failed}
        d = self.engine.databases.get(db)
        rp_name = rp or (d.default_rp if d else "autogen")
        ids = sorted(self.data_nodes())
        dest_of = self._owners_memo(db, rp, rp_name, ids)
        for p in points:
            dest = dest_of(p[2])
            if sum(1 for o in dest if o not in dead) < need:
                return False
        return True

    # -- hinted handoff ----------------------------------------------------

    def _hints_dir(self) -> str:
        import os

        d = os.path.join(self.engine.root, "hints")
        os.makedirs(d, exist_ok=True)
        return d

    def hint(self, node_id: str, db: str, rp: str | None,
             points: list) -> None:
        """Queue replica copies for a down node (jsonl per target)."""
        import os

        rec = {"db": db, "rp": rp, "points": encode_points(points)}
        path = os.path.join(self._hints_dir(), f"{node_id}.jsonl")
        _fp("cluster-hint-before-append")  # copy owed, nothing durable yet
        with self._hint_lock:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + "\n")
        _fp("cluster-hint-after-append")  # hint durable, ack not yet sent

    def pending_hint_nodes(self) -> set[str]:
        """Nodes with queued hints FROM THIS coordinator: excluded from
        this coordinator's read live-set so a just-recovered replica is
        not made primary before its copies arrive (other coordinators'
        hints are invisible here — a documented per-coordinator bound)."""
        import os

        with self._hint_lock:
            try:
                names = os.listdir(self._hints_dir())
            except OSError:
                return set()
        # .inflight files (crash mid-replay) still hold undelivered copies
        # for their node — it must stay excluded until they are merged
        # back (replay_hints start) and delivered
        return {f[:-6] for f in names if f.endswith(".jsonl")} | {
            f[: -len(".jsonl.inflight")]
            for f in names
            if f.endswith(".jsonl.inflight")
        }

    def replay_hints(self) -> int:
        """Deliver queued hints to recovered nodes; returns points
        delivered. Idempotent (timestamp last-write-wins), so a crash
        mid-replay at worst re-delivers. The live file is atomically
        RENAMED before processing: writes arriving mid-replay append to
        a fresh file and can never be lost to a stale-snapshot rewrite."""
        import os
        import urllib.error

        from opengemini_tpu_torch.storage.engine import WriteError

        delivered = 0
        d = self._hints_dir()
        with self._hint_lock:
            # merge back any .inflight orphaned by a crash mid-replay:
            # prepend its lines to the node's live queue (idempotent LWW
            # delivery makes the worst case a re-delivery, never a loss)
            try:
                leftover = sorted(os.listdir(d))
            except OSError:
                return 0
            for fname in leftover:
                if not fname.endswith(".jsonl.inflight"):
                    continue
                infl = os.path.join(d, fname)
                live = os.path.join(d, fname[: -len(".inflight")])
                try:
                    with open(infl, "rb") as f:
                        data = f.read()
                except OSError:
                    continue
                extra = b""
                try:
                    with open(live, "rb") as f:
                        extra = f.read()
                except OSError:
                    pass
                tmp = live + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                    if data and not data.endswith(b"\n"):
                        f.write(b"\n")
                    f.write(extra)
                os.replace(tmp, live)
                try:
                    os.remove(infl)
                except OSError:
                    pass
            files = sorted(os.listdir(d))
        for fname in files:
            if not fname.endswith(".jsonl"):
                continue
            node_id = fname[:-6]
            path = os.path.join(d, fname)
            inflight = path + ".inflight"
            with self._hint_lock:
                try:
                    os.replace(path, inflight)  # atomic capture
                except OSError:
                    continue
            try:
                with open(inflight, encoding="utf-8") as f:
                    lines = f.read().splitlines()
            except OSError:
                continue
            remaining = list(lines)
            # hints owed to a node that left the roster (decommission)
            # are RE-ROUTED through the normal write path: the rows land
            # on the group's CURRENT owners instead — an acked hinted
            # copy must never vanish just because its target did
            reroute = node_id not in self.data_nodes()
            for i, line in enumerate(lines):
                try:
                    rec = json.loads(line)
                    points = decode_points(rec["points"])
                    _fp("cluster-replay-before-forward")
                    if reroute:
                        self.routed_write(rec["db"], rec.get("rp"),
                                          points, "one")
                    else:
                        self.forward_points(node_id, rec["db"],
                                            rec.get("rp"), points)
                    delivered += len(points)
                    remaining[i] = None
                except urllib.error.HTTPError as e:
                    if e.code == 400:
                        # the replica deterministically rejected the
                        # payload (unparseable points): replaying can
                        # never succeed — poison, drop this hint only
                        remaining[i] = None
                        continue
                    # anything else (429 backpressure, 403 during a
                    # cluster-token rotation, 5xx) can clear: a hinted
                    # copy may BE the ack at consistency=any, so keep
                    # the rest queued and retry next tick rather than
                    # destroy acked durability
                    break
                except (OSError, RemoteScanError):
                    break  # node still down: keep the rest queued
                except WriteError:
                    # re-route target gone too (database/rp dropped since
                    # the hint was queued): deterministically
                    # undeliverable — poison, drop this hint only
                    remaining[i] = None
                except (ValueError, KeyError, TypeError):
                    remaining[i] = None  # corrupt hint: drop it
            kept = [l for l in remaining if l is not None]
            _fp("cluster-replay-before-requeue")  # undelivered tail in
            with self._hint_lock:                 # .inflight only
                if kept:
                    # re-queue BEFORE any hints appended mid-replay: append
                    # the live file (if any) after the kept prefix
                    extra = b""
                    try:
                        with open(path, "rb") as f:
                            extra = f.read()
                    except OSError:
                        pass
                    tmp = path + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(("\n".join(kept) + "\n").encode())
                        f.write(extra)
                    os.replace(tmp, path)
                try:
                    os.remove(inflight)
                except OSError:
                    pass
        return delivered

    # -- shard migration / rebalancing --------------------------------------

    MIGRATE_CHUNK = 20_000  # points per forwarded batch

    # -- load-aware balancing (reference: balance_manager.go) --------------

    def collect_loads(self, deadline: float | None = None) -> dict[str, dict]:
        """{node_id: disk_usage doc} for every reachable data node
        (local node measured directly).  `deadline` is an absolute
        time.perf_counter() stamp: once past it the poll stops early so
        one slow peer cannot stretch a balance pass past its budget
        (breaker-open peers already fail fast via CircuitOpen)."""
        import time as _time
        out: dict[str, dict] = {}
        for nid, addr in sorted(self.data_nodes().items()):
            if nid == self.self_id:
                out[nid] = self.engine.disk_usage()
                continue
            if deadline is not None and _time.perf_counter() >= deadline:
                break  # budget spent: decide on what we have
            try:
                out[nid] = self._post(addr, "/internal/load", {"db": "_"})
            except (OSError, RemoteScanError, ValueError):
                continue  # unreachable node: skip this round
        return out

    def balance_round(self, min_skew_bytes: int = 64 << 20,
                      skew_ratio: float = 1.3,
                      budget_s: float | None = None) -> dict | None:
        """ONE load-balancing decision (meta-leader only): when the
        heaviest data node carries skew_ratio x the lightest (and at
        least min_skew_bytes more), move the largest group whose PRIMARY
        is the heavy node to the light one via a raft-replicated
        placement override — every node's group_owners() then excludes
        the heavy node and its own migrate_round() streams the data over
        the existing two-phase machinery. Returns the decision or None.
        Reference: app/ts-meta/meta/balance_manager.go /
        master_pt_balance_manager.go (load-reactive PT moves; rendezvous
        handles membership-change moves already)."""
        import time as _time
        deadline = (None if budget_s is None
                    else _time.perf_counter() + budget_s)
        loads = self.collect_loads(deadline)
        if len(loads) < 2:
            return None
        self._prune_placements(loads)
        hot = max(loads, key=lambda n: loads[n].get("total", 0))
        cold = min(loads, key=lambda n: loads[n].get("total", 0))
        hot_b = loads[hot].get("total", 0)
        cold_b = loads[cold].get("total", 0)
        if hot == cold or hot_b < cold_b * skew_ratio + min_skew_bytes:
            return None
        ids = sorted(self.data_nodes())
        over = getattr(self.meta_store.fsm, "placement", {}) or {}
        best = None
        for key, size in sorted(loads[hot].get("groups", {}).items(),
                                key=lambda kv: -kv[1]):
            try:
                db, rp, start = key.split("|")
                start_i = int(start)
            except ValueError:
                continue  # name containing '|' (legacy data): skip
            cur = self.group_owners(db, rp, start_i, nodes=ids)
            if cur and cur[0] == hot and cold not in cur:
                # moving more than half the skew would just flip it
                if size <= (hot_b - cold_b) * 0.75 and size > 0:
                    best = (key, size, cur)
                    break
        if best is None:
            return None
        key, size, cur = best
        if cold != self.self_id and self.breaker.enabled():
            cold_addr = self.data_nodes().get(cold, "")
            if cold_addr and self.breaker.is_open(cold_addr):
                # the chosen destination stopped answering since its load
                # report: proposing the override would strand the group
                # behind migrate_round retries against a dead peer
                return None
        new_owners = self._propose_owner_swap(key, cur, hot, cold)
        if new_owners is None:
            return None
        STATS.incr("cluster", "balance_moves")
        return {"group": key, "bytes": size, "from": hot, "to": cold,
                "owners": new_owners, "prior": over.get(key)}

    def _propose_owner_swap(self, key: str, cur: list[str], out_node: str,
                            dest: str) -> list[str] | None:
        """Raft-propose a placement override moving group `key` off
        `out_node` onto `dest`.  Retained current owners stay FIRST:
        with rf>1 the primary must keep holding the data while migration
        is still in flight, or the primary-filtered reads would
        black-hole the group until out_node's next migrate_round (the
        new owner has no rows yet); with rf=1 the list is just [dest]
        and unfiltered reads keep serving out_node's copy until the move
        commits.  Returns the new owner list, or None (rf already
        saturated by data-holding owners, or the proposal failed)."""
        new_owners = [n for n in cur if n != out_node] + [dest]
        new_owners = new_owners[: max(1, self.rf)]
        if dest not in new_owners:
            return None
        if not self._propose_placement(key, new_owners):
            return None
        return new_owners

    def _prune_placements(self, loads: dict) -> None:
        """Overrides must not pin groups forever: drop entries whose group
        no longer exists on any reporting node (retention expired /
        dropped) or whose owner list already equals plain rendezvous
        (membership change caught up). Without this, the placement map
        grows monotonically and defeats rendezvous self-balancing."""
        over = dict(getattr(self.meta_store.fsm, "placement", {}) or {})
        if not over:
            return
        held: set[str] = set()
        for doc in loads.values():
            held.update(doc.get("groups", {}))
        ids = sorted(self.data_nodes())
        for key, owner_list in over.items():
            try:
                db, rp, start = key.split("|")
                start_i = int(start)
            except ValueError:
                continue
            stale = key not in held or \
                owner_list == owners(ids, db, rp, start_i, self.rf)
            if stale:
                self.meta_store.propose_and_wait(
                    {"op": "drop_placement", "key": key})

    def force_move(self, db: str | None = None,
                   dest: str | None = None) -> dict | None:
        """Deterministic balancer decision for operators and the cluster
        torture harness (POST /debug/ctrl?mod=cluster&op=move): pick the
        largest shard group this node owns and propose a placement
        override moving it to a node outside the current owner set — no
        byte skew required.  `dest` pins the destination (elastic node
        add: rebalance onto a JOINING node instead of whichever node
        sorts first); default is the first non-owner.  Like
        balance_round, retained data-holding owners stay FIRST so rf>1
        primary-filtered reads never black-hole the group mid-move; the
        data streams when this node's next migrate_round observes the
        lost ownership.  Returns the decision or None (nothing movable /
        unknown dest / not the meta leader)."""
        ids = sorted(self.data_nodes())
        if len(ids) < 2:
            return None
        if dest is not None and dest not in ids:
            return None  # unknown destination: not in the roster (yet)
        usage = self.engine.disk_usage()
        best = None
        for key, _size in sorted(usage.get("groups", {}).items(),
                                 key=lambda kv: (-kv[1], kv[0])):
            try:
                gdb, rp, start = key.split("|")
                start_i = int(start)
            except ValueError:
                continue
            if db and gdb != db:
                continue
            cur = self.group_owners(gdb, rp, start_i, nodes=ids)
            if self.self_id not in cur:
                continue
            if dest is not None:
                if dest in cur:
                    continue  # already an owner of this group
                best = (key, cur, dest)
                break
            others = [n for n in ids if n not in cur]
            if not others:
                continue
            best = (key, cur, others[0])
            break
        if best is None:
            return None
        key, cur, dest = best
        new_owners = self._propose_owner_swap(key, cur, self.self_id, dest)
        if new_owners is None:
            return None
        STATS.incr("cluster", "forced_moves")
        return {"group": key, "from": self.self_id, "to": dest,
                "owners": new_owners}

    # -- elastic membership (online node add / decommission) ----------------

    def _leader_post(self, path: str, body: dict) -> bool:
        """Forward a roster/placement mutation to the meta leader over
        HTTP (any node may initiate; raft serializes at the leader).
        True on a 200 — anything else, including no known leader, is a
        clean False for the caller to retry."""
        hint = self.meta_store.leader_hint()
        addr = self.meta_store.meta_members().get(hint or "", "")
        if not addr:
            return False
        doc = dict(body)
        doc["token"] = self.token
        req = urllib.request.Request(
            peers.url(addr, path), data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with peers.urlopen(req, timeout=self.timeout_s) as r:
                return r.status == 200
        except OSError:
            return False

    def _propose_placement(self, key: str, new_owners: list[str]) -> bool:
        """Raft-replicate one placement override, proposing locally on
        the leader and forwarding through /cluster/placement otherwise
        (drain and force_move must work when issued on a follower)."""
        if self.meta_store.is_leader():
            return bool(self.meta_store.propose_and_wait(
                {"op": "set_placement", "key": key, "owners": new_owners}))
        return self._leader_post("/cluster/placement",
                                 {"key": key, "owners": new_owners})

    def add_node(self, node_id: str, addr: str, role: str = "data") -> dict:
        """Operator-driven roster add (POST /debug/ctrl?mod=cluster&
        op=add).  A node started with [meta] join registers itself
        (server/app.py joiner + registrar); this op covers
        pre-registration, repair after a lost registration, and tests.
        Placement onto the new node follows from rendezvous plus
        balancer moves — data streams over the ordinary two-phase
        migration, nothing special-cased for joins."""
        if not node_id or not addr:
            return {"ok": False, "error": "id and addr required"}
        if self.meta_store.is_leader():
            ok = bool(self.meta_store.propose_and_wait(
                {"op": "register_node", "id": node_id, "addr": addr,
                 "role": role}))
        else:
            ok = self._leader_post("/cluster/register", {
                "id": node_id, "addr": addr, "role": role})
        if ok:
            STATS.incr("cluster", "nodes_added")
        return {"ok": ok, "node": node_id, "addr": addr,
                "nodes": sorted(self.data_nodes())}

    def _roster_remove(self, node_id: str) -> bool:
        if self.meta_store.is_leader():
            return bool(self.meta_store.propose_and_wait(
                {"op": "remove_node", "id": node_id}))
        return self._leader_post("/cluster/deregister", {"id": node_id})

    def _conf_remove(self, node_id: str) -> bool:
        """Drop a node from the raft voter set (no-op for data-only
        nodes that never joined the meta group)."""
        if node_id not in self.meta_store.meta_members():
            return True
        if self.meta_store.is_leader():
            return bool(
                self.meta_store.propose_conf_change("remove", node_id))
        return self._leader_post("/raft/remove", {"id": node_id})

    def drain_round(self) -> dict:
        """ONE drain pass moving this node's data off (POST /debug/ctrl?
        mod=cluster&op=drain): (1) raft-replicated placement overrides
        disown every locally-held group — every coordinator re-routes at
        the same committed index, so no peer's migrate_round can push
        the group BACK mid-drain; (2) migrate_round streams the disowned
        groups over the existing durable two-phase machinery; (3)
        replay_hints drains copies owed to peers.  Writes that land here
        mid-pass (the old placement still routed them) are picked up by
        the next pass — they re-route or hint, never vanish.  Returns
        progress counters; repeat until remaining_groups == 0 and
        pending_hints is empty."""
        ids = sorted(self.data_nodes())
        others = [n for n in ids if n != self.self_id]
        doc: dict = {"overridden": 0, "migrated": 0, "hints_replayed": 0,
                     "dead_dests": []}
        if not others:
            doc["error"] = "cannot drain the last data node"
            doc["remaining_groups"] = len(self.engine._shards)
            doc["pending_hints"] = sorted(self.pending_hint_nodes())
            return doc
        for (db, rp, start) in sorted(self.engine._shards):
            cur = self.group_owners(db, rp, start, nodes=ids)
            if self.self_id not in cur:
                continue
            # retained data-holding owners stay FIRST (primary-filtered
            # reads keep a data-holding primary mid-move), then fill
            # from the post-removal rendezvous order so the override
            # equals plain rendezvous once the roster drops this node —
            # _prune_placements then retires it automatically
            post = owners(others, db, rp, start, self.rf)
            new = [n for n in cur if n != self.self_id]
            new += [n for n in post if n not in new]
            new = new[: max(1, min(self.rf, len(others)))]
            if new and self._propose_placement(f"{db}|{rp}|{start}", new):
                doc["overridden"] += 1
        if self.breaker.enabled():
            # migration already fails fast against these (CircuitOpen is
            # never retried in _commit_with_retry); surfacing them lets
            # the decommission loop stop early instead of spinning
            doc["dead_dests"] = sorted(
                n for n, a in self.data_nodes().items()
                if n != self.self_id and a and self.breaker.is_open(a))
        doc["migrated"] = self.migrate_round()
        doc["hints_replayed"] = self.replay_hints()
        doc["remaining_groups"] = len(self.engine._shards)
        doc["pending_hints"] = sorted(self.pending_hint_nodes())
        STATS.incr("cluster", "drain_rounds")
        return doc

    def decommission(self, node: str | None = None,
                     deadline_s: float = 60.0) -> dict:
        """Drain-then-remove (POST /debug/ctrl?mod=cluster&
        op=decommission).  For THIS node: (0) with rf>1, one
        anti-entropy round repairs this node's replicas while it still
        owns them, so the copies it sheds are complete even if a peer
        replica dies later; (1) drain passes under a perf_counter
        deadline — each pass re-disowns any NEW groups full traffic
        created meanwhile; (2) roster removal (remove_node through the
        meta store): every coordinator's rendezvous excludes this node
        from the committed index on, and late hints for it re-route
        through replay_hints; (3) raft conf-change removal when this
        node is a meta voter; (4) final drain passes for in-flight
        writes that raced the removal.  Idempotent — re-issue after a
        mid-drain crash or partition and it resumes from the durable
        state (placements, staging, hint queues).

        With `node` set to a PEER id, this is the forced path for a
        node that died and cannot drain itself: roster + conf-change
        removal only.  Acked rows survive on their rf>1 replicas;
        anti-entropy re-replicates them to the new owners and local
        hints for the dead node re-route on the next replay."""
        import time as _time

        if node and node != self.self_id:
            return self._force_remove(node)
        t0 = _time.perf_counter()
        deadline = t0 + max(1.0, deadline_s)
        state: dict = {"phase": "draining", "node": self.self_id,
                       "rounds": 0, "overridden": 0, "migrated": 0,
                       "done": False}
        self.decommission_state = state
        if self.rf > 1:
            try:
                state["repaired"] = self.anti_entropy_round()
            except Exception as e:  # noqa: BLE001 — repair best-effort
                state["repair_error"] = str(e)
        drained = False
        while _time.perf_counter() < deadline:
            doc = self.drain_round()
            state["rounds"] += 1
            state["overridden"] += doc["overridden"]
            state["migrated"] += doc["migrated"]
            state["last_round"] = doc
            if doc.get("error"):
                state["phase"] = "failed"
                state["error"] = doc["error"]
                return state
            if doc["remaining_groups"] == 0 and not doc["pending_hints"]:
                drained = True
                break
            if doc["dead_dests"] and not doc["migrated"]:
                # every blocked group waits on a breaker-open dest: fail
                # fast rather than pinning the drain until the deadline
                state["phase"] = "blocked"
                state["blocked_on"] = doc["dead_dests"]
                return state
            _time.sleep(
                min(0.2, max(0.0, deadline - _time.perf_counter())))
        if not drained:
            state["phase"] = "deadline"
            return state
        state["phase"] = "removing"
        state["roster_removed"] = self._roster_remove(self.self_id)
        state["conf_removed"] = self._conf_remove(self.self_id)
        # in-flight writes that the pre-removal placement routed here
        # land in fresh local groups: push them off too (bounded — the
        # write sources saw the roster change at the commit index)
        for _ in range(3):
            final = self.drain_round()
            state["final_round"] = final
            if (final["remaining_groups"] == 0
                    and not final["pending_hints"]):
                break
            if _time.perf_counter() >= deadline:
                break
        state["done"] = bool(state["roster_removed"])
        state["phase"] = "done" if state["done"] else "failed"
        state["elapsed_s"] = round(_time.perf_counter() - t0, 3)
        if state["done"]:
            STATS.incr("cluster", "decommissions")
        return state

    def _force_remove(self, node_id: str) -> dict:
        """Forced removal of a peer that cannot drain itself (died
        mid-drain, lost hardware).  See decommission()."""
        state: dict = {"phase": "removing", "node": node_id,
                       "forced": True, "done": False}
        self.decommission_state = state
        known = node_id in self.data_nodes()
        state["roster_removed"] = (
            self._roster_remove(node_id) if known else True)
        state["conf_removed"] = self._conf_remove(node_id)
        state["hints_replayed"] = self.replay_hints()
        state["done"] = bool(state["roster_removed"])
        state["phase"] = "done" if state["done"] else "failed"
        if state["done"]:
            STATS.incr("cluster", "decommissions")
        return state

    def migrate_round(self) -> int:
        """Rebalancing after membership change — TWO-PHASE (reference:
        app/ts-meta/meta/migrate_state_machine.go + engine/engine_ha.go
        PreAssign/Assign/Rollback): for each shard group held locally
        whose rendezvous owners no longer include this node, every
        destination opens an INVISIBLE staging area (begin), rows stream
        into it, and only a commit folds them into the live shard —
        queries never observe a half-migrated copy. Any failure aborts
        the staging best-effort; a pusher that dies mid-stream leaves
        staging dirs that the destinations TTL-expire (the rollback that
        survives coordinator death). The local copy drops only after
        every destination commits. Beyond the reference, a destination
        already holding our digest of the group (a retained owner) takes
        no push (`_lacking`). Returns groups migrated."""
        import uuid

        ids = sorted(self.data_nodes())
        moved = 0
        for (db, rp, start), sh in sorted(self.engine._shards.items()):
            dest = self.group_owners(db, rp, start, nodes=ids)
            if self.self_id in dest:
                continue
            if not all(self.node_up(peer) for peer in dest):
                continue  # owner down (quorum view): retry when healed
            # a retained owner whose copy already has our digest takes
            # no push (the reference re-folds the same rows into it: last
            # write wins); it counts as committed
            dest = self._lacking(dest, db, rp, start, sh)
            mig_id = f"mig-{self.self_id}-{uuid.uuid4().hex[:12]}"
            begun: list[str] = []
            try:
                for peer in dest:
                    _fp("cluster-migrate-before-begin")
                    self._migrate_rpc(peer, {
                        "phase": "begin", "mig_id": mig_id, "db": db,
                        "rp": rp, "group_start": start})
                    begun.append(peer)
                for peer in dest:
                    self._push_shard(peer, db, rp, sh, mig_id)
                for peer in dest:
                    _fp("cluster-migrate-before-commit")
                    self._commit_with_retry(peer, mig_id, db)
                _fp("cluster-migrate-after-commit")  # all acks in, local
            except Exception:                        # copy still present
                # Rollback: ANY failure — transport, a peer's rejection,
                # or a payload encode/decode fault (ValueError/KeyError,
                # which previously ESCAPED this handler and left staging
                # un-rolled-back until TTL) — aborts every begun peer
                # best-effort; TTL expiry covers peers the abort cannot
                # reach.  The local copy stays, so nothing is lost.
                STATS.incr("cluster", "migrate_aborts")
                for peer in begun:
                    try:
                        _fp("cluster-migrate-before-abort")
                        self._migrate_rpc(peer, {
                            "phase": "abort", "mig_id": mig_id, "db": db})
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
                continue
            # drop-local ONLY here, after every destination acked its
            # commit — a kill at the site above leaves the group held by
            # a non-owner, which the next migrate_round re-pushes (LWW
            # fold into the already-live rows: convergent, no dupes)
            _fp("cluster-migrate-before-drop-local")
            self.engine.drop_shard(db, rp, start)
            moved += 1
            STATS.incr("cluster", "groups_migrated")
        return moved

    def _lacking(self, dest: list, db: str, rp, start: int, sh) -> list:
        """The destinations whose copy of the group differs from ours
        (/internal/digest, anti-entropy's digest); a peer that cannot
        answer counts as lacking."""
        mine = None
        out = []
        for peer in dest:
            addr = self.data_nodes().get(peer, "")
            try:
                theirs = self._post(addr, "/internal/digest", {
                    "db": db, "rp": rp, "group_start": start})["digest"]
            except (OSError, KeyError, TypeError, ValueError):
                theirs = None
            if theirs:
                if mine is None:
                    mine = sh.content_digest()
                if theirs == mine:
                    continue
            out.append(peer)
        return out

    COMMIT_RETRIES = 3

    def _commit_with_retry(self, peer: str, mig_id: str, db: str) -> None:
        """Commit with bounded retries: the server side is idempotent (a
        committed-marker answers a re-commit with ok), so a commit whose
        ACK was lost in transit is safely retried here instead of
        aborting — and then re-streaming — a fully staged migration."""
        import random as _random
        import time as _time

        last: Exception | None = None
        for i in range(self.COMMIT_RETRIES):
            try:
                self._migrate_rpc(peer, {
                    "phase": "commit", "mig_id": mig_id, "db": db})
                return
            except urllib.error.HTTPError:
                raise  # the peer ANSWERED (e.g. 400 unknown migration):
                       # its classification is final, never retried
            except CircuitOpen:
                raise  # fail fast means fail fast: backing off against
                       # a peer the breaker already classified dead
                       # would just burn the migrate round's time
            except (OSError, RemoteScanError) as e:
                last = e
                if i + 1 < self.COMMIT_RETRIES:
                    base = max(self.rpc_backoff_ms, 20.0) / 1000.0
                    _time.sleep(min(base * (2 ** i) * (1 + _random.random()),
                                    2.0))
        raise last

    def _migrate_rpc(self, peer: str, body: dict) -> None:
        addr = self.data_nodes().get(peer, "")
        if not addr:
            raise RemoteScanError(f"no address for data node {peer!r}")
        try:
            # commit folds the whole staged group into the live shard
            # synchronously — far longer than a data-plane RPC
            timeout = 300.0 if body.get("phase") == "commit" else None
            got = self._post(addr, "/internal/migrate", body,
                             timeout=timeout)
        except OSError as e:
            raise RemoteScanError(
                f"data node {peer!r} ({addr}) migrate "
                f"{body.get('phase')} failed: {e}") from e
        if not got.get("ok"):
            raise RemoteScanError(
                f"data node {peer!r} rejected migrate {body.get('phase')}")

    def _push_shard(self, peer: str, db: str, rp, sh, mig_id: str) -> None:
        """Stream every row of one local shard into `peer`'s staging area
        in bounded structured-write batches (extraction shared with
        engine.commit_staging via iter_structured_batches)."""
        from opengemini_tpu_torch.storage.shard import iter_structured_batches

        for batch in iter_structured_batches(sh, self.MIGRATE_CHUNK):
            _fp("cluster-migrate-before-push")
            self._migrate_rpc(peer, {
                "phase": "write", "mig_id": mig_id, "db": db,
                "points": encode_points(batch)})

    # -- anti-entropy (rf>1 replica convergence) ----------------------------

    def anti_entropy_round(self) -> int:
        """One digest-exchange round (reference raft-replicated shards
        keep replicas consistent by construction,
        engine/engine_replication.go; the rendezvous+LWW data plane needs
        this read-repair instead): for every shard group this node owns,
        compare per-measurement content digests with the other live
        owners and pull any diverged measurement's rows back for LWW
        merge.  Symmetric rounds on each owner converge both ways.
        Returns the number of repaired (group, measurement) pairs."""
        if self.rf <= 1:
            return 0
        ids = sorted(self.data_nodes())
        nodes = self.data_nodes()
        pending = self.pending_hint_nodes()
        repaired = 0

        # candidate groups: everything held locally PLUS groups the other
        # owners hold that we should — a replica that lost its whole
        # shard directory must still notice and re-pull
        candidates: dict[tuple, object] = {
            key: sh for key, sh in self.engine._shards.items()
        }
        peer_addrs: dict[str, str] = {}
        for peer in ids:
            if peer == self.self_id:
                continue
            if peer in pending or not self.node_up(peer):
                continue  # hints still owed / peer down: not divergence
            addr = nodes.get(peer, "")
            if not addr:
                continue
            peer_addrs[peer] = addr
            try:
                got = self._post(addr, "/internal/groups", {"db": "_"})
            except (OSError, ValueError):
                peer_addrs.pop(peer, None)
                continue
            for db, rp, start in got.get("groups", []):
                candidates.setdefault((db, rp, int(start)), None)

        for (db, rp, start), sh in sorted(candidates.items()):
            dest = self.group_owners(db, rp, start, nodes=ids)
            if self.self_id not in dest:
                continue
            local_digest = sh.content_digest() if sh is not None else {}
            if sh is not None:
                tmin, tmax = sh.tmin, sh.tmax
            else:
                d = self.engine.databases.get(db)
                rp_meta = d.rps.get(rp) if d else None
                dur = rp_meta.shard_duration_ns if rp_meta else 0
                tmin, tmax = start, start + (dur or 2**62 - start)
            for peer in dest:
                if peer == self.self_id or peer not in peer_addrs:
                    continue
                addr = peer_addrs[peer]
                try:
                    _fp("cluster-antientropy-before-digest")
                    got = self._post(addr, "/internal/digest", {
                        "db": db, "rp": rp, "group_start": start,
                    })
                except (OSError, ValueError):
                    continue
                theirs = got.get("digest", {})
                for mst in sorted(set(theirs) | set(local_digest)):
                    if theirs.get(mst) == local_digest.get(mst):
                        continue
                    if mst not in theirs:
                        continue  # peer missing data: ITS round pulls ours
                    try:
                        _fp("cluster-antientropy-before-pull")
                        n = self._pull_measurement(
                            addr, db, rp, mst, tmin, tmax)
                    except (OSError, RemoteScanError, ValueError):
                        continue
                    if n:
                        repaired += 1
                        STATS.incr("cluster", "anti_entropy_repairs")
        return repaired

    def _pull_measurement(self, addr: str, db: str, rp, mst: str,
                          tmin: int, tmax: int) -> int:
        """Fetch a peer's rows for one (group, measurement) and LWW-merge
        them locally via the structured write path."""
        payload = self._post_scan(addr, {
            "db": db, "rp": rp, "mst": mst, "tmin": tmin, "tmax": tmax,
            "fmt": "bin",
        })
        points = payload_to_points(mst, payload)
        if not points:
            return 0
        _fp("cluster-antientropy-before-merge")  # pulled, not yet merged
        return write_points(self.engine, db, points, rp)

    def forward_points(self, node_id: str, db: str, rp: str | None,
                       points: list) -> None:
        """POST structured points to the owner's /internal/write."""
        addr = self.data_nodes().get(node_id, "")
        if not addr:
            raise RemoteScanError(f"no address for data node {node_id!r}")
        body = {"db": db, "rp": rp, "points": encode_points(points)}
        tctx = tracing.current_ctx()
        if tctx is not None:
            body["trace"] = tctx
        try:
            out = self._post(addr, "/internal/write", body)
            if isinstance(out, dict):
                # replica applied under a child span and shipped it back
                tracing.current().graft(out.get("trace"))
        except urllib.error.HTTPError:
            # status errors carry the replica's classification (429 =
            # transient write backpressure vs 4xx = hard rejection);
            # HTTPError is an OSError, so without this re-raise the
            # clause below would flatten both into RemoteScanError and
            # callers could not tell them apart
            raise
        except OSError as e:
            raise RemoteScanError(
                f"data node {node_id!r} ({addr}) write failed: {e}"
            ) from e

    def forward_write(self, node_id: str, db: str, rp: str | None,
                      lines: str) -> None:
        from urllib.parse import quote

        addr = self.data_nodes().get(node_id, "")
        if not addr:
            raise RemoteScanError(f"no address for data node {node_id!r}")
        url = peers.url(addr, f"/write?db={quote(db, safe='')}")
        if rp:
            url += f"&rp={quote(rp, safe='')}"
        netfault.check(self.self_id, "/write", node_id, addr)
        req = urllib.request.Request(
            url, data=lines.encode("utf-8"),
            headers={"X-Ogt-Internal": "1", "X-Ogt-Token": self.token},
            method="POST",
        )
        peers.urlopen(req, timeout=self.timeout_s).read()

    def _post_raw(self, addr: str, path: str, body: dict,
                  timeout: float | None = None):
        """One internal-POST implementation (token injection, per-RPC
        deadline, netfault hook, circuit breaker, transient retries);
        returns (bytes, content_type).

        Retry policy (OGT_RPC_RETRIES, default 0 = single attempt):
        only transport-level OSErrors retry, with jittered exponential
        backoff — every /internal/* RPC is idempotent (LWW structured
        writes, marker-idempotent migration commits, read-only scans),
        so a retried request can duplicate effort but never data.  An
        HTTPError is the peer ANSWERING and is never retried here: the
        status carries the peer's classification and the caller's
        error taxonomy must see it unchanged."""
        import random as _random
        import time as _time

        data = json.dumps(dict(body, token=self.token)).encode("utf-8")
        attempts = self.rpc_retries + 1
        for i in range(attempts):
            if not self.breaker.allow(addr):
                # fail fast means fail fast: never retried, not a new
                # failure observation
                raise CircuitOpen(
                    f"circuit open to {addr} "
                    f"({self.breaker.threshold} consecutive failures)")
            req = urllib.request.Request(
                peers.url(addr, path), data=data,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            t0 = _time.perf_counter_ns()
            try:
                # inside the try: an injected drop/delay/error behaves
                # exactly like the real transport fault it simulates
                # (drops retry, injected statuses classify as answers)
                netfault.check(self.self_id, path, addr)
                with peers.urlopen(req, timeout=timeout or self.timeout_s) as r:
                    out = r.read(), r.headers.get("Content-Type", "")
            except urllib.error.HTTPError:
                self.breaker.record(addr, True)  # the peer answered
                _observe_ns("rpc_seconds",
                            _time.perf_counter_ns() - t0,
                            peer=addr, path=path)
                raise
            except OSError:
                self.breaker.record(addr, False)
                if i + 1 >= attempts:
                    raise
                base = self.rpc_backoff_ms / 1000.0
                _time.sleep(min(base * (2 ** i) * (1 + _random.random()),
                                2.0))
                continue
            self.breaker.record(addr, True)
            # per-(peer, path) latency: the straggler-attribution gauge —
            # which node ate the time when a fan-out query is slow
            _observe_ns("rpc_seconds", _time.perf_counter_ns() - t0,
                        peer=addr, path=path)
            return out

    def _post(self, addr: str, path: str, body: dict,
              timeout: float | None = None) -> dict:
        data, _ct = self._post_raw(addr, path, body, timeout=timeout)
        return json.loads(data)

    def _post_scan(self, addr: str, body: dict) -> dict:
        """Scan post accepting the binary wire format (raw ndarray
        buffers) with JSON fallback for peers that ignore fmt."""
        data, ctype = self._post_raw(addr, "/internal/scan", body)
        if ctype.startswith("application/octet-stream"):
            return parse_series_binary(data)
        return json.loads(data)

    def scan_shards(self, db: str, rp: str | None, mst: str,
                    tmin: int, tmax: int):
        """(remote shards, live node set). With rf>1 each group is served
        exactly once by its primary AMONG THE LIVE SET: dead peers are
        dropped from `live` (all at once — one retry round) and the
        group's next owner becomes primary (replica failover). At most
        rf-1 dead nodes are tolerable: every group has rf distinct
        owners, so with >= rf nodes down SOME group may have lost every
        copy — the query fails rather than answer partially. rf=1
        tolerates none for the same reason."""
        live = self._initial_live()
        dropped: list[str] = []
        while True:
            payloads, dead = self._fetch_once(db, rp, mst, tmin, tmax, live)
            if not dead:
                cur = tracing.current()
                for p in payloads:
                    # stitch each peer's scan subtree (shipped in the
                    # response header) under the span issuing this round
                    cur.graft(p.pop("trace", None) if isinstance(p, dict)
                              else None)
                out = [RemoteShard(mst, p) for p in payloads
                       if p.get("series")]
                return out, live
            _fp("cluster-scan-failover")  # dead peers leave the live set
            dropped.extend(sorted(dead))
            if len(dropped) >= self.rf:
                raise RemoteScanError(
                    f"{len(dropped)} data nodes unreachable "
                    f"({', '.join(dropped)}) with replication factor "
                    f"{self.rf}: some shard groups may have no live copy"
                )
            live = [n for n in live if n not in dead]

    def _initial_live(self) -> list[str]:
        """Starting live set for a read fan-out: every registered data
        node, minus (rf>1) recovered replicas still missing OUR hinted
        copies — they must not serve as primary until the queue drains."""
        live = sorted(self.data_nodes())
        if self.rf > 1:
            pending = self.pending_hint_nodes() - {self.self_id}
            if pending and len(live) - len(pending & set(live)) >= 1:
                live = [n for n in live if n not in pending]
        return live

    def has_peers(self) -> bool:
        return any(nid != self.self_id for nid in self.data_nodes())

    def select_meta(self, db: str, rp: str | None, mst: str,
                    tmin: int, tmax: int):
        """Pushdown metadata round: merged (tag_keys, schema, dmin, dmax)
        across peers, with the same replica-failover semantics as
        scan_shards. Returns (merged doc | None, live)."""
        STATS.incr("cluster", "meta_fanouts")
        live = self._initial_live()
        dropped: list[str] = []
        while True:
            def fetch(nid, addr):
                if nid not in live:
                    return {}
                if not addr:
                    return _NodeDown(nid, f"no address for data node {nid!r}")
                try:
                    return self._post(addr, "/internal/select_meta", {
                        "db": db, "rp": rp, "mst": mst,
                        "tmin": tmin, "tmax": tmax,
                        "live": live, "rf": self.rf,
                    })
                except urllib.error.HTTPError as e:
                    # the peer is ALIVE but rejected the round (governor
                    # shed / rolling upgrade): not a node-down — treating
                    # it as dead would fail the query "unreachable" at
                    # rf=1 and evict a merely-overloaded replica from
                    # the live set at rf>1.  PartialsUnavailable makes
                    # the executor fall back to the raw column exchange.
                    return PartialsUnavailable(
                        f"data node {nid!r} ({addr}) cannot serve "
                        f"metadata: {e}")
                except OSError as e:
                    return _NodeDown(
                        nid, f"data node {nid!r} ({addr}) unreachable: {e}")

            metas, dead = [], set()
            for got in self._fanout(fetch):
                if isinstance(got, PartialsUnavailable):
                    raise got
                if isinstance(got, _NodeDown):
                    dead.add(got.nid)
                elif got:
                    metas.append(got)
            if not dead:
                break
            _fp("cluster-scan-failover")
            dropped.extend(sorted(dead))
            if len(dropped) >= self.rf:
                raise RemoteScanError(
                    f"{len(dropped)} data nodes unreachable "
                    f"({', '.join(dropped)}) with replication factor "
                    f"{self.rf}: some shard groups may have no live copy")
            live = [n for n in live if n not in dead]
        tag_keys: set[str] = set()
        schema: dict[str, str] = {}
        dmin = dmax = None
        for m in metas:
            tag_keys.update(m.get("tag_keys", []))
            for n, t in m.get("schema", {}).items():
                schema.setdefault(n, t)
            if m.get("dmin") is not None:
                dmin = m["dmin"] if dmin is None else min(dmin, m["dmin"])
                dmax = m["dmax"] if dmax is None else max(dmax, m["dmax"])
        if not schema and dmin is None and not tag_keys:
            return None, live
        return ({"tag_keys": tag_keys, "schema": schema,
                 "dmin": dmin, "dmax": dmax}, live)

    def select_partials(self, req: dict, live: list[str]) -> list[dict]:
        """Partial-aggregate round against the live set pinned by the
        metadata round. Any death here shifts primary ownership, which
        invalidates the coordinator's whole plan — raise PartialsRetry
        so the statement rebuilds, instead of silently merging a
        now-inconsistent primary view."""
        from opengemini_tpu_torch.query.partials import parse_partials

        STATS.incr("cluster", "partials_fanouts")
        body = dict(req, live=live, rf=self.rf)
        # wire trace ctx captured HERE, on the query thread — the fetch
        # closures run on fan-out workers with no thread-local trace
        tctx = tracing.current_ctx()
        if tctx is not None:
            body["trace"] = tctx

        def fetch(nid, addr):
            if nid not in live:
                return {}
            if not addr:
                return _NodeDown(nid, f"no address for data node {nid!r}")
            try:
                raw, _ct = self._post_raw(addr, "/internal/select_partials", body)
                return (nid, parse_partials(raw))
            except urllib.error.HTTPError as e:
                # the peer is ALIVE but errored (bad request / missing
                # endpoint during a rolling upgrade): not a node-down
                return PartialsUnavailable(
                    f"data node {nid!r} ({addr}) cannot serve partials: {e}")
            except OSError as e:
                return _NodeDown(
                    nid, f"data node {nid!r} ({addr}) unreachable: {e}")

        docs = []
        for got in self._fanout(fetch):
            if isinstance(got, PartialsUnavailable):
                raise got
            if isinstance(got, _NodeDown):
                raise PartialsRetry(str(got))
            if got:
                docs.append(got)
        docs.sort(key=lambda p: p[0])  # deterministic tie-break order
        return [d for _nid, d in docs]

    def _fetch_once(self, db, rp, mst, tmin, tmax, live):
        """One fan-out round. Returns (payloads, dead node ids) —
        collecting EVERY dead peer in the round so failover retries once,
        not once per dead node."""
        STATS.incr("cluster", "scan_fanouts")
        tctx = tracing.current_ctx()  # captured on the query thread

        def fetch(nid, addr):
            if nid not in live:
                return {}
            if not addr:
                return _NodeDown(nid, f"no address for data node {nid!r}")
            body = {
                "db": db, "rp": rp, "mst": mst,
                "tmin": tmin, "tmax": tmax,
                "live": live, "rf": self.rf, "fmt": "bin",
            }
            if tctx is not None:
                body["trace"] = tctx
            try:
                return self._post_scan(addr, body)
            except urllib.error.HTTPError as e:
                if e.code in (429, 503):
                    # alive peer SHED the scan (governor admission or
                    # backpressure): the raw exchange is the bottom of
                    # the fallback chain, so this is a clean retryable
                    # query error — NOT a node-down, which would
                    # misreport "unreachable" and evict a merely-
                    # overloaded replica from the live set
                    raise RemoteScanError(
                        f"data node {nid!r} ({addr}) rejected scan: {e}"
                    ) from e
                # any other status (500 disk fault, 404 rolling
                # upgrade): the peer cannot serve this scan — fail over
                # to a replica like an unreachable node, else one sick-
                # but-alive node fails every query touching its shards
                return _NodeDown(
                    nid, f"data node {nid!r} ({addr}) cannot scan: {e}"
                )
            except OSError as e:
                return _NodeDown(
                    nid, f"data node {nid!r} ({addr}) unreachable: {e}"
                )

        payloads, dead = [], set()
        for got in self._fanout(fetch):
            if isinstance(got, _NodeDown):
                dead.add(got.nid)
            else:
                payloads.append(got)
        return payloads, dead

    def _fanout(self, fetch):
        """Run fetch(nid, addr) against every peer concurrently; one slow
        peer bounds latency instead of summing across the cluster."""
        from concurrent.futures import ThreadPoolExecutor

        peers = [(nid, addr) for nid, addr in sorted(self.data_nodes().items())
                 if nid != self.self_id]
        if not peers:
            return []
        with ThreadPoolExecutor(max_workers=min(16, len(peers))) as pool:
            return list(pool.map(lambda p: fetch(*p), peers))

    def remote_measurements(self, db: str, rp: str | None) -> set[str]:
        """Measurement names across peers, with the same rf-1 dead-node
        tolerance as scans (names are replicated with the data)."""
        def fetch(nid, addr):
            if not addr:
                return _NodeDown(nid, f"no address for data node {nid!r}")
            try:
                return self._post(addr, "/internal/measurements",
                                  {"db": db, "rp": rp})
            except OSError as e:
                return _NodeDown(
                    nid, f"data node {nid!r} ({addr}) unreachable: {e}"
                )

        names: set[str] = set()
        dead: list[_NodeDown] = []
        for got in self._fanout(fetch):
            if isinstance(got, _NodeDown):
                dead.append(got)
            else:
                names.update(got.get("measurements", []))
        if len(dead) >= self.rf:
            raise RemoteScanError(str(dead[0]))
        return names
