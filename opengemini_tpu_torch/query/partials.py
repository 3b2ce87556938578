"""Distributed partial aggregation: the peer side of aggregate pushdown
and the coordinator's merge.

The port of ``opengemini_tpu/query/partials.py``. Each peer runs the
same batches the coordinator would (``pick_batch``: the grid, kernel 3,
for GROUP BY time(); the bucketed batch, kernels 1 and 2, for selectors
by tag) over its own shards on its own engine's device, against the
coordinator's window grid, and ships one dense per-(group, window)
partial array set, O(groups x windows) for the mergeable aggregates,
which the coordinator merges with numpy before rendering. Rank
aggregates ship per-segment (value, count) multisets instead: O(groups x
distinct values), which nears O(rows) on continuous float fields, so a
density cutoff refuses such answers and the coordinator falls back to
the raw column exchange (``PartialsUnavailable``).

Mergeability (what travels per requested aggregate):
  count          -> count
  sum            -> sum            mean   -> sum + count
  min/max        -> value + exact ns time (selector rendering)
  first/last     -> value + exact ns time (lexicographic winner)
  spread         -> min + max
  stddev         -> count + mean + M2 (Chan et al.'s pairwise combine)

Everything else (host transforms, ...) falls back to the raw column
exchange (parallel/cluster.serialize_series_binary). The wire format
([u32 header_len][header JSON][little-endian arrays]) is the JAX
package's byte for byte, so a peer of either package serves a
coordinator of the other.
"""

from __future__ import annotations

import json
import struct

import numpy as np

# aggregate names whose cross-node merge is lossless from the partial set
MERGEABLE = {
    "count", "sum", "mean", "min", "max", "first", "last", "spread", "stddev",
}

# rank-based aggregates: not mergeable from FIXED-SIZE partials, but
# exactly mergeable from per-segment (value, count) multisets — peers ship
# O(groups x distinct-values) instead of raw columns (reference
# distributes these via hash exchange; here the multiset IS the exchange)
MULTISET_MERGEABLE = {"median", "percentile", "count_distinct"}

# partial arrays required per requested aggregate
_REQUIRES = {
    "count": (),
    "sum": ("sum",),
    "mean": ("sum",),
    "min": ("min",),
    "max": ("max",),
    "first": ("first",),
    "last": ("last",),
    "spread": ("min", "max"),
    "stddev": ("mean", "m2"),
    # the ragged multiset trio travels as mvals/mcnts/moffs on the wire
    "median": ("mset",),
    "percentile": ("mset",),
    "count_distinct": ("mset",),
}

_BIG = np.int64(2**62)


def partial_names(agg_names) -> list[str]:
    """Wire partial-array names for a field's requested aggregates.
    count is always present: it doubles as the per-window presence mask."""
    out = {"count"}
    for a in agg_names:
        out.update(_REQUIRES[a])
    return sorted(out)


# -- peer side ---------------------------------------------------------------


def compute_partials(engine, router, req: dict) -> bytes:
    """Run the local slice of a distributed aggregate query.

    req (built by DataRouter.select_partials): db, rp, mst, tmin, tmax,
    aligned, every_ns, offset_ns, W, group_tags, aggs {field: [names]},
    tag_expr / field_expr (astjson docs), live, rf.
    """
    from opengemini_tpu_torch.models import templates
    from opengemini_tpu_torch.ops import aggregates as aggmod
    from opengemini_tpu_torch.ops import window as winmod
    from opengemini_tpu_torch.query import condition as cond
    from opengemini_tpu_torch.query.executor import pick_batch
    from opengemini_tpu_torch.query.qhelpers import (
        _add_record_to_batches,
        _prune_text_sids,
    )
    from opengemini_tpu_torch.sql import astjson

    db, rp, mst = req["db"], req.get("rp") or None, req["mst"]
    tmin, tmax = int(req["tmin"]), int(req["tmax"])
    aligned, W = int(req["aligned"]), int(req["W"])
    every = int(req.get("every_ns") or 0)
    offset = int(req.get("offset_ns") or 0)
    group_tags = list(req["group_tags"])
    per_field = {f: list(names) for f, names in req["aggs"].items()}
    tag_expr = astjson.from_json(req.get("tag_expr"))
    field_expr = astjson.from_json(req.get("field_expr"))
    mixed_expr = astjson.from_json(req.get("mixed_expr"))

    shards = engine.shards_for_range(db, rp, tmin, tmax)
    live = req.get("live")
    if int(req.get("rf", 1)) > 1 and live and router is not None:
        shards = [
            sh for sh in shards
            if router.is_primary(db, rp, sh.tmin, live)
        ]

    schema = {}
    tag_keys: set[str] = set()
    for sh in shards:
        schema.update(sh.schema(mst))
        tag_keys.update(sh.index.tag_keys(mst))
    if req.get("tag_keys") is not None:
        # the coordinator's classification governs: a tag key it knows but
        # no peer-local shard indexes must still inject as an empty-string
        # column in row evaluation (tag != 'x' over a missing tag is TRUE,
        # not column-missing-false)
        tag_keys = set(req["tag_keys"])
    # peer-side SplitCondition over the coordinator's view; this only
    # drives row evaluation here
    sc = cond.SplitCondition(tmin, tmax, tag_expr, field_expr, mixed_expr,
                             frozenset(tag_keys))
    sc.mixed_series_level = bool(req.get("mixed_series_level"))

    read_fields = sorted(set(per_field) | cond.row_filter_refs(sc))
    dtype = templates.compute_dtype()
    # the coordinator's grid_ctx: peers take the same windows-on-lanes
    # path for stride-regular data (both sides pick identical numerics),
    # on this engine's device
    grid_ctx = (W, every) if every else None
    batches = {
        f: pick_batch(schema, per_field[f], f, dtype, engine.device,
                      grid_ctx)
        for f in per_field
    }

    # replica-side child trace (utils/tracing): parented at the
    # coordinator's wire ctx when the request carries one, shipped back
    # in the partials header so the coordinator stitches one tree
    from opengemini_tpu_torch.utils import tracing

    trace, cm = tracing.start_remote_activated(
        "select_partials", req.get("trace"),
        node=getattr(router, "self_id", "") or "")
    with cm:
        cur = tracing.current()
        # group bookkeeping against the COORDINATOR's grid.  Two passes
        # under separate spans: index-side series selection ("scan"),
        # then chunk decode + batch staging ("decode") — the per-stage
        # split is what straggler attribution needs when one node's
        # partials round is slow
        gid_of: dict[tuple, int] = {}
        group_keys: list[tuple] = []
        group_tag_dicts: list[dict] = []
        match_terms = [] if every else cond.conjunctive_match_terms(field_expr)
        plan: list[tuple] = []  # (shard, sid, gid, tags)
        with cur.span("scan") as sp:
            for sh in shards:
                sids = cond.eval_tag_expr(tag_expr, sh.index, mst)
                if mixed_expr is not None:
                    if sc.mixed_series_level:  # hinted: exact series filter
                        sids &= cond.series_only_sids(
                            mixed_expr, sh.index, mst, tag_keys)
                    else:
                        sids &= cond.tag_superset_sids(
                            mixed_expr, sh.index, mst, tag_keys)
                sids = _prune_text_sids(sh, mst, sids, match_terms)
                for sid in sorted(sids):
                    tags = sh.index.tags_of(sid)
                    key = tuple(tags.get(k, "") for k in group_tags)
                    gid = gid_of.get(key)
                    if gid is None:
                        gid = len(group_keys)
                        gid_of[key] = gid
                        group_keys.append(key)
                        group_tag_dicts.append(
                            {k: tags.get(k, "") for k in group_tags})
                    plan.append((sh, sid, gid, tags))
            sp.add_field("shards", len(shards))
            sp.add_field("series", len(plan))
        rows = 0
        with cur.span("decode") as sp:
            # one bulk read per shard for many series, as the executor's
            # scan does (a per-series read decodes each packed chunk once
            # per series it holds); rows reach the batches in the same
            # (series, time) order either way
            fields_sorted = sorted(per_field)
            by_shard: dict[int, tuple] = {}
            for entry in plan:
                by_shard.setdefault(id(entry[0]), (entry[0], []))[1].append(
                    entry)
            for sh, entries in by_shard.values():
                if len(entries) >= 64 and hasattr(sh, "read_series_bulk"):
                    sid_sorted = np.asarray([e[1] for e in entries],
                                            np.int64)
                    gid_sorted = np.asarray([e[2] for e in entries],
                                            np.int64)
                    sid_arr, rec = sh.read_series_bulk(
                        mst, sid_sorted, tmin, tmax, fields=read_fields)
                    if len(rec) == 0:
                        continue
                    rows += len(rec)
                    fmask = (cond.eval_row_filter(sc, rec, sid_arr=sid_arr,
                                                  index=sh.index)
                             if sc.has_row_filter else None)
                    gid_rows = gid_sorted[np.searchsorted(sid_sorted,
                                                          sid_arr)]
                    if every:
                        widx, _ = winmod.window_index(
                            rec.times, tmin, every, offset)
                        seg = (gid_rows * W + widx.astype(np.int64)
                               ).astype(np.int32)
                    else:
                        seg = gid_rows.astype(np.int32)
                    _add_record_to_batches(
                        rec, seg, aligned, fields_sorted, batches, dtype,
                        fmask, sids=sid_arr)
                    continue
                for _sh, sid, gid, tags in entries:
                    rec = sh.read_series(mst, sid, tmin, tmax,
                                         fields=read_fields)
                    if len(rec) == 0:
                        continue
                    rows += len(rec)
                    fmask = (cond.eval_row_filter(sc, rec, tags=tags)
                             if sc.has_row_filter else None)
                    if every:
                        widx, _ = winmod.window_index(
                            rec.times, tmin, every, offset)
                        seg = (gid * W + widx.astype(np.int64)
                               ).astype(np.int32)
                    else:
                        seg = np.full(len(rec), gid, dtype=np.int32)
                    _add_record_to_batches(
                        rec, seg, aligned, fields_sorted, batches, dtype,
                        fmask, sids=sid)
            sp.add_field("rows", rows)

        with cur.span("partial_merge") as sp:
            fields_out = _compute_field_partials(
                per_field, batches, group_keys, W, aggmod)
            sp.add_field("fields", len(fields_out))
    return serialize_partials(group_tag_dicts, fields_out,
                              len(group_keys), W,
                              trace=tracing.ship_subtree(trace))


def _compute_field_partials(per_field, batches, group_keys, W, aggmod):
    """Run the partial-array computation for every requested field (the
    peer-side 'partial_merge' stage): {field: {partial_name: array}}."""
    n_seg = max(len(group_keys), 1) * W
    fields_out: dict[str, dict[str, np.ndarray]] = {}
    for f, names in per_field.items():
        batch = batches[f]
        want = partial_names(names)
        arrs: dict[str, np.ndarray] = {}
        counts = None

        def run(spec_name):
            out, sel, cnt = batch.run(aggmod.get(spec_name), n_seg)
            return out, sel, cnt

        for p in want:
            if p == "count":
                _o, _s, counts = run("count")
                arrs["count"] = np.asarray(counts, np.int64)
            elif p == "sum":
                out, _s, counts = run("sum")
                arrs["sum"] = np.asarray(out)
            elif p in ("min", "max", "first", "last"):
                out, sel, counts = run(p)
                arrs[p + "_v"] = np.asarray(out, np.float64)
                times = batch.host_times()
                if sel is not None and len(times):
                    t = times[np.clip(np.asarray(sel), 0, len(times) - 1)]
                else:
                    t = np.zeros(n_seg, np.int64)
                arrs[p + "_t"] = np.asarray(t, np.int64)
            elif p == "mean":
                out, _s, counts = run("mean")
                arrs["mean"] = np.asarray(out, np.float64)
            elif p == "m2":
                sd, _s, counts = run("stddev")
                c = np.asarray(counts, np.float64)
                arrs["m2"] = np.asarray(sd, np.float64) ** 2 * np.maximum(
                    c - 1, 0
                )
            elif p == "mset":
                mv, mc, mo = batch.host_value_multiset(n_seg)
                if len(mv) > 10_000 and len(mv) > 0.5 * max(batch.n, 1):
                    # continuous float fields: distinct ~ rows, the
                    # multiset wire would exceed a raw value column —
                    # refuse (the 400 becomes PartialsUnavailable on the
                    # coordinator, which falls back to the raw exchange)
                    raise ValueError(
                        "rank-aggregate multiset too dense "
                        f"({len(mv)} distinct / {batch.n} rows)")
                arrs["mvals"] = mv
                arrs["mcnts"] = mc
                arrs["moffs"] = mo
        if counts is None:
            _o, _s, counts = run("count")
        arrs.setdefault("count", np.asarray(counts, np.int64))
        fields_out[f] = arrs

    ngroups = len(group_keys)
    if ngroups * W != n_seg:  # zero local groups: ship empty arrays
        def _slice(p, a):
            if p == "moffs":
                return a[: ngroups * W + 1]  # offsets carry one extra slot
            if p in ("mvals", "mcnts"):
                return a  # already empty with zero groups
            return a[: ngroups * W]

        fields_out = {
            f: {p: _slice(p, a) for p, a in arrs.items()}
            for f, arrs in fields_out.items()
        }
    return fields_out


# -- wire format -------------------------------------------------------------
# [u32 header_len][header JSON][raw little-endian array buffers]


def serialize_partials(group_tag_dicts, fields_out, ngroups: int, W: int,
                       trace: dict | None = None) -> bytes:
    buffers: list[bytes] = []
    off = 0

    def add(arr: np.ndarray) -> dict:
        nonlocal off
        a = np.ascontiguousarray(arr)
        d = "<i8" if a.dtype.kind in "iu" else "<f8"
        b = a.astype(d, copy=False).tobytes()
        buffers.append(b)
        loc = {"d": d, "o": off, "n": len(b)}
        off += len(b)
        return loc

    header = {
        "groups": group_tag_dicts,
        "W": W,
        "fields": {
            f: {p: add(arr) for p, arr in arrs.items()}
            for f, arrs in fields_out.items()
        },
    }
    if trace is not None:
        # the replica's span subtree rides the header (JSON next to the
        # group/field directory, never the raw buffers)
        header["trace"] = trace
    hbuf = json.dumps(header, separators=(",", ":")).encode()
    return struct.pack("<I", len(hbuf)) + hbuf + b"".join(buffers)


def parse_partials(data: bytes) -> dict:
    (hlen,) = struct.unpack_from("<I", data, 0)
    header = json.loads(data[4 : 4 + hlen])
    payload = memoryview(data)[4 + hlen :]
    fields = {}
    for f, arrs in header["fields"].items():
        fields[f] = {
            p: np.frombuffer(payload[loc["o"] : loc["o"] + loc["n"]], loc["d"])
            for p, loc in arrs.items()
        }
    out = {"groups": header["groups"], "W": header["W"], "fields": fields}
    if "trace" in header:
        out["trace"] = header["trace"]
    return out


# -- coordinator side --------------------------------------------------------


def merge_remote_partials(
    agg_results, aggs, batches, group_keys, W, peer_docs, group_tags,
):
    """Fold peers' partial docs into the locally-computed agg_results.

    Mutates group_keys in place (appending remote-only groups) and
    REPLACES each mergeable call's entry with the cluster-wide result:
    (values, None, counts, spec, field, times_abs|None). Stack order for
    time ties is local first, then peers in the order given (the caller
    passes them sorted by node id) — deterministic across retries.
    """
    from opengemini_tpu_torch.ops import aggregates as aggmod

    gid_of = {k: i for i, k in enumerate(group_keys)}
    for doc in peer_docs:
        for gtags in doc["groups"]:
            key = tuple(gtags.get(k, "") for k in group_tags)
            if key not in gid_of:
                gid_of[key] = len(group_keys)
                group_keys.append(key)
    n_seg = len(group_keys) * W

    def expand(arr, fill=0):
        arr = np.asarray(arr)
        if len(arr) == n_seg:
            return arr
        out = np.full(n_seg, fill, dtype=arr.dtype if fill == 0 else np.float64)
        out[: len(arr)] = arr
        return out

    # per-peer segment index maps (peer-local seg -> global seg)
    peer_maps = []
    for doc in peer_docs:
        gmap = np.array(
            [gid_of[tuple(g.get(k, "") for k in group_tags)] for g in doc["groups"]],
            dtype=np.int64,
        )
        if len(gmap):
            segs = (gmap[:, None] * W + np.arange(W)[None, :]).reshape(-1)
        else:
            segs = np.empty(0, np.int64)
        peer_maps.append(segs)

    def scatter(doc_i, field, pname, fill, dtype=np.float64):
        """Peer partial array -> global-shaped array with `fill` holes.
        dtype=int64 keeps ns timestamps exact (they do not fit f64)."""
        out = np.full(n_seg, fill, dtype)
        arrs = peer_docs[doc_i]["fields"].get(field)
        segs = peer_maps[doc_i]
        if arrs is None or pname not in arrs or not len(segs):
            return out
        a = np.asarray(arrs[pname], dtype)
        out[segs[: len(a)]] = a
        return out

    def peer_counts(field):
        return [
            scatter(i, field, "count", 0).astype(np.int64)
            for i in range(len(peer_docs))
        ]

    for call, spec, params, fname in aggs:
        if spec.name in MULTISET_MERGEABLE:
            entry = agg_results[id(call)]
            l_counts = entry[2]
            pc = peer_counts(fname)
            total_counts = expand(l_counts) + sum(pc)
            out = _merge_multiset(
                spec, params, entry, batches[fname], l_counts, fname,
                peer_docs, peer_maps, n_seg,
            )
            agg_results[id(call)] = (
                out, None, total_counts, spec, fname, None)
            continue
        if spec.name not in MERGEABLE:
            continue
        entry = agg_results[id(call)]
        l_out, l_counts = entry[0], entry[2]
        n_local = len(l_counts)
        pc = peer_counts(fname)
        total_counts = expand(l_counts) + sum(pc)
        times_abs = None

        if spec.name == "count":
            out = expand(np.asarray(l_out, np.int64)) + sum(pc)
        elif spec.name == "sum":
            # int sums stay int64 end-to-end (exact beyond 2^53) when
            # every source shipped int64 partials
            raws = [
                (peer_maps[i], np.asarray(peer_docs[i]["fields"][fname]["sum"]))
                for i in range(len(peer_docs))
                if "sum" in peer_docs[i]["fields"].get(fname, {})
            ]
            all_int = np.asarray(l_out).dtype.kind in "iu" and all(
                a.dtype.kind in "iu" for _s, a in raws
            )
            acc = expand(
                np.asarray(l_out, np.int64 if all_int else np.float64)
            ).copy()
            for segs, a in raws:
                if len(segs) and len(a):
                    acc[segs[: len(a)]] += a.astype(acc.dtype)
            out = acc
        elif spec.name == "mean":
            # local sum = local mean * local count — recovered from the
            # FINAL local entry so pre-aggregation fast-path contributions
            # (which never enter the device batch) are included
            l_sum = np.asarray(l_out, np.float64) * np.asarray(
                l_counts, np.float64
            )
            total_sum = expand(l_sum) + sum(
                scatter(i, fname, "sum", 0) for i in range(len(peer_docs))
            )
            out = total_sum / np.maximum(total_counts, 1)
        elif spec.name in ("min", "max", "first", "last"):
            out, times_abs = _merge_selector(
                spec.name, entry, batches[fname], l_counts, pc, fname,
                peer_docs, scatter, expand, n_seg,
            )
        elif spec.name == "spread":
            mn, _t1 = _merge_selector(
                "min", None, batches[fname], l_counts, pc, fname,
                peer_docs, scatter, expand, n_seg, local_spec="min",
            )
            mx, _t2 = _merge_selector(
                "max", None, batches[fname], l_counts, pc, fname,
                peer_docs, scatter, expand, n_seg, local_spec="max",
            )
            out = mx - mn
            if np.asarray(entry[0]).dtype.kind in "iu":
                out = np.rint(out).astype(np.int64)
        elif spec.name == "stddev":
            out = _merge_stddev(
                entry, batches[fname], l_counts, pc, fname, peer_docs,
                scatter, expand, n_seg,
            )
        else:  # pragma: no cover — MERGEABLE guard above
            continue

        agg_results[id(call)] = (out, None, total_counts, spec, fname, times_abs)


def _merge_multiset(spec, params, entry, batch, l_counts, fname, peer_docs,
                    peer_maps, n_seg):
    """Exact cluster-wide rank aggregate from per-segment (value, count)
    multisets: local batch rows + every peer's shipped trio, combined and
    rank-selected with the SAME semantics as the device kernels
    (ops/segment.py seg_percentile nearest-rank, seg_median two-middle
    mean, seg_count_distinct)."""
    n_local = len(l_counts)
    lv, lc, loffs = batch.host_value_multiset(n_local)
    segs_all = [np.repeat(np.arange(n_local, dtype=np.int64),
                          np.diff(loffs))]
    vals_all = [lv]
    cnts_all = [lc]
    for i, doc in enumerate(peer_docs):
        arrs = doc["fields"].get(fname) or {}
        if "mvals" not in arrs or not len(peer_maps[i]):
            continue
        offs = np.asarray(arrs["moffs"], np.int64)
        pv = np.asarray(arrs["mvals"], np.float64)
        pcn = np.asarray(arrs["mcnts"], np.int64)
        per_seg = np.diff(offs)
        local_seg = np.repeat(np.arange(len(per_seg), dtype=np.int64), per_seg)
        segs_all.append(peer_maps[i][local_seg])
        vals_all.append(pv)
        cnts_all.append(pcn)
    seg = np.concatenate(segs_all)
    val = np.concatenate(vals_all)
    cnt = np.concatenate(cnts_all)
    if len(seg) == 0:
        dtype = np.int64 if spec.int_output else np.float64
        return np.zeros(n_seg, dtype)
    order = np.lexsort((val, seg))
    seg, val, cnt = seg[order], val[order], cnt[order]
    totals = np.bincount(seg, weights=cnt, minlength=n_seg).astype(np.int64)

    if spec.name == "count_distinct":
        head = np.empty(len(seg), np.bool_)
        head[0] = True
        head[1:] = (seg[1:] != seg[:-1]) | (val[1:] != val[:-1])
        return np.bincount(seg[head], minlength=n_seg).astype(np.int64)

    csum = np.cumsum(cnt)
    first_run = np.searchsorted(seg, np.arange(n_seg), "left")
    base = np.where(first_run > 0, csum[np.maximum(first_run, 1) - 1], 0)

    def value_at_rank(rank):
        """rank is 1-indexed within each segment."""
        target = base + np.clip(rank, 1, np.maximum(totals, 1))
        idx = np.searchsorted(csum, target, "left")
        return val[np.clip(idx, 0, len(val) - 1)]

    if spec.name == "percentile":
        q = float(params[0]) if params else 50.0
        rank = np.ceil(q / 100.0 * totals).astype(np.int64)
        out = value_at_rank(rank)
    else:  # median: mean of the two middle values
        lo = value_at_rank((totals - 1) // 2 + 1)
        hi = value_at_rank(totals // 2 + 1)
        out = (lo + hi) / 2.0
    if np.asarray(entry[0]).dtype.kind in "iu" and spec.name == "percentile":
        out = np.rint(out).astype(np.int64)
    return np.where(totals > 0, out, 0.0 if out.dtype.kind == "f" else 0)


def _local_selector(batch, spec_name, n_local):
    from opengemini_tpu_torch.ops import aggregates as aggmod

    out, sel, counts = batch.run(aggmod.get(spec_name), n_local)
    times = batch.host_times()
    if sel is not None and len(times):
        t = times[np.clip(np.asarray(sel), 0, len(times) - 1)]
    else:
        t = np.zeros(n_local, np.int64)
    return np.asarray(out, np.float64), np.asarray(t, np.int64), counts


def _merge_selector(
    name, entry, batch, l_counts, pc, fname, peer_docs, scatter, expand,
    n_seg, local_spec=None,
):
    """Merge a value+time selector across local + peers.

    min/max pick the extreme VALUE (time = that point's time); first/last
    pick the extreme TIME. Ties resolve to the earliest source in stack
    order (local, then peers by node id) — one real point, deterministic."""
    n_local = len(l_counts) if entry is None else len(entry[2])
    if entry is not None and entry[1] is not None:
        l_out = np.asarray(entry[0], np.float64)
        times = batch.host_times()
        l_t = (
            times[np.clip(np.asarray(entry[1]), 0, len(times) - 1)]
            if len(times) else np.zeros(n_local, np.int64)
        )
    else:
        l_out, l_t, _c = _local_selector(batch, local_spec or name, n_local)
    l_present = expand(l_counts[:n_local] if entry is None else entry[2]) > 0
    vals = [expand(l_out)]
    ts = [expand(l_t).astype(np.int64)]
    present = [l_present]
    for i in range(len(peer_docs)):
        vals.append(scatter(i, fname, name + "_v", np.nan))
        ts.append(scatter(i, fname, name + "_t", 0, np.int64))
        present.append(pc[i] > 0)
    V = np.stack(vals)
    T = np.stack(ts)
    P = np.stack(present)
    if name in ("min", "max"):
        # value ties break by EARLIEST timestamp — same rule as the
        # single-device kernels (ops/segment.py) and the mesh merge
        key = np.where(P, V, np.inf if name == "min" else -np.inf)
        best = key.min(0) if name == "min" else key.max(0)
        cand = P & (V == best[None, :])
        tkey = np.where(cand, T, _BIG)
        pick = np.argmin(tkey, 0)
    else:
        key = np.where(P, T, _BIG if name == "first" else -_BIG)
        tbest = key.min(0) if name == "first" else key.max(0)
        cand = P & (T == tbest[None, :])
        # exact-time ties across sources: larger value wins (reference
        # FirstReduce/LastReduce); remaining ties to stack order
        vbest = np.where(cand, V, -np.inf).max(0)
        cand &= V == vbest[None, :]
        pick = np.argmax(cand, 0)
    idx = (pick, np.arange(n_seg))
    return V[idx], T[idx]


def _merge_stddev(
    entry, batch, l_counts, pc, fname, peer_docs, scatter, expand, n_seg,
):
    """Chan et al. pairwise (n, mean, M2) combine across sources."""
    from opengemini_tpu_torch.ops import aggregates as aggmod

    n_local = len(entry[2])
    l_sd = np.asarray(entry[0], np.float64)
    l_mean, _s, _c = batch.run(aggmod.get("mean"), n_local)
    n = expand(entry[2]).astype(np.float64)
    mean = expand(np.asarray(l_mean, np.float64))
    m2 = expand(l_sd) ** 2 * np.maximum(n - 1, 0)
    for i in range(len(peer_docs)):
        nb = pc[i].astype(np.float64)
        mb = scatter(i, fname, "mean", 0.0)
        m2b = scatter(i, fname, "m2", 0.0)
        tot = n + nb
        safe = np.maximum(tot, 1)
        delta = mb - mean
        mean = np.where(tot > 0, (n * mean + nb * mb) / safe, 0.0)
        m2 = m2 + m2b + delta * delta * n * nb / safe
        n = tot
    return np.sqrt(np.maximum(m2 / np.maximum(n - 1, 1), 0.0))
