"""Regular-grid dense batch: the windows-on-lanes fast path for GROUP BY
time() over stride-regular data.

The port of ``opengemini_tpu/models/grid.py``. TSBS-shaped data — every
series sampled on a constant stride — lets windowed aggregation skip the
segment machinery: samples go into a dense (series_run,
samples_per_window, num_windows) grid and every per-window statistic is
one reduce over the middle axis, which the CUDA kernel
``cuda_segment.grid_window_agg`` does on the card.

GridBatch is SPECULATIVE: add() accumulates raw rows exactly like
BucketedBatch; the first run() checks regularity (one global stride that
divides the window, per-series-run constant spacing, bounded density
waste) and either assembles the grid or delegates to a BucketedBatch
built from the same rows. Only the layout changes, never the answer.
The ``executor`` counters of ``utils.stats.GLOBAL`` record which path
engaged (grid_batches against grid_fallbacks).

Contract is the AggBatch/BucketedBatch contract: add(values, rel_ns,
seg_ids, mask, times_ns, sids=...) + run(spec, num_segments, params) ->
(values, sel|None, counts), where sel indexes the batch's host_times()
row order.

``add_encoded`` takes a value column still in its on-disk blocks
(record.EncodedColumn). When every add of a batch arrives encoded, the
offload planner (query/offload.py, kernel "grid_decode", geometry
(shape, dtype)) picks the route: its static prior sends cold encoded
columns to the device and columns the host already decoded to the host.
On the device route the freeze ships the encoded bytes and
ops/device_decode.py decodes, scatters and reduces on the card
(executor/grid_decode_fused); the decoded grid stays there for the ssd
and selector groups. Otherwise (executor/grid_decode_fallbacks, or the
host route) the freeze decodes on the host and scatters as before. Both
routes feed the planner their walls (``observe``): the device route the
fused run, the host route its decode and scatter plus each kernel
group's transfer and launch, each up to the card's finishing (the
fetch that follows waits for it anyway). A host decision the planner
flags for pre-warming registers the fused site's builder.

With the device tier of the decoded-column cache on
(storage/colcache.py), the executor stamps a scan signature on the
batch (``device_cache_token``). The freeze consults the tier first: a
hit runs kernel 3 on the retained tensors, with no host scatter, no
decode and no transfer. A miss builds the grid as above and retains it:
the fused decode's output, or the host grid after one transfer
(``colcache-fill``).

With a device mesh configured (parallel/runtime.py) and at least as many
grid rows as shards, the row axis is padded to a multiple of the mesh
size and split over its shards (parallel/distributed.py ``Sharded``):
kernel 3 and the ssd and selector groups run once per shard on its
rows, and the host concatenates the shards' per-row outputs (series
runs are independent rows, so nothing merges across shards). Across
processes a rank places, decodes and reduces its own shards' rows only,
and the per-row outputs come back whole on every rank
(``distributed.fetch_np``'s all_gather). The
encoded cold scan's route is then "mesh": each shard decodes its own
contiguous row range (ops/device_decode.py ``build_mesh_grid_plan``).
The retained device-tier entry is sharded; without the tier the sharded
grid is the batch's own, keyed by the mesh epoch and a row of the
device-memory ledger (owner ``grid_mesh``). A reload that changes the
mesh reshards the retained entry (colcache ``device_get``) or rebuilds
the batch's layout from its rows; a layout of a dead mesh is never
served.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from opengemini_tpu_torch.models import ragged, templates
from opengemini_tpu_torch.ops import cuda_segment, device_decode
from opengemini_tpu_torch.parallel import distributed, runtime
from opengemini_tpu_torch.query import offload
from opengemini_tpu_torch.storage import colcache
from opengemini_tpu_torch.utils import devobs
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

# aggregates the grid path serves; others never get routed here
GRID_AGGS = {"count", "sum", "mean", "min", "max", "spread", "stddev",
             "first", "last"}

_MIN_S = 8
_MIN_W = 8
# hard cap on grid slots and max slots per scanned row (sparse series
# would explode the dense grid)
_MAX_GRID_CELLS = 1 << 26
_MAX_EXPANSION = 8
# samples-per-window above this would make (S, k, W) degenerate; bucketed
# split rows handle it better
_MAX_K = 8192
# lane (W) axis padding quantum: one constant on the card. Padded lanes
# are masked off, so the quantum changes no answer.
_LANE_QUANTUM = 8


class _EncodedVals:
    """Array-like holder of one add_encoded() value column that is still
    in its on-disk encoded blocks (record.EncodedColumn): the grid
    freeze ships the raw payloads to the device decoder; any host
    consumer — the bucketed fallback, the host scatter — decodes via
    __array__, the same numbers by construction."""

    __slots__ = ("col",)

    def __init__(self, col):
        self.col = col

    def __len__(self):
        return len(self.col)

    def __array__(self, dtype=None, copy=None):
        v = self.col.values
        return np.asarray(v, dtype=dtype) if dtype is not None \
            else np.asarray(v)


class GridBatch:
    accepts_boundaries = True  # coalesced adds forward record breaks

    def __init__(self, dtype, W: int, every_ns: int, device):
        self.dtype = np.dtype(dtype or templates.compute_dtype())
        self.W = int(W)
        self.every_ns = int(every_ns)
        self.device = device
        self._vals: list[np.ndarray] = []
        self._rel: list[np.ndarray] = []
        self._seg: list[np.ndarray] = []
        self._mask: list[np.ndarray] = []
        self._times: list[np.ndarray] = []
        self._sids: list[np.ndarray | None] = []
        self._bnds: list[np.ndarray | None] = []
        self.n = 0
        self._state = None  # grid state dict after a successful freeze
        self._fallback = None  # BucketedBatch when the grid refuses
        self._raw: dict = {}  # lazy per-(row, window) device stats
        # scan signature for the decoded-column cache's device tier: the
        # executor stamps it when the scan is deterministic, and the
        # grid tensors are then retained and reused across identical
        # scans
        self.device_cache_token = None

    def add(self, values, rel_ns, seg_ids, mask, times_ns, sids=None,
            boundaries=None):
        """`boundaries` (optional sorted row offsets within this add)
        marks run breaks inside a coalesced add — per-shard sid numbering
        is independent, so a stager that concatenates records from
        different shards must keep equal sid values from fusing into one
        stride run."""
        self._push(np.asarray(values, dtype=self.dtype), rel_ns, seg_ids,
                   mask, times_ns, sids, boundaries)

    def add_encoded(self, col, rel_ns, seg_ids, mask, times_ns, sids=None,
                    boundaries=None):
        """add() taking a still-encoded value column
        (record.EncodedColumn): when EVERY add of the batch arrives
        encoded, the freeze can decode on the card; every other path
        decodes on the host through the column's lazy .values,
        bit-identically."""
        self._push(_EncodedVals(col), rel_ns, seg_ids, mask, times_ns,
                   sids, boundaries)

    def _push(self, vals, rel_ns, seg_ids, mask, times_ns, sids,
              boundaries):
        self._vals.append(vals)
        self._rel.append(np.asarray(rel_ns, dtype=np.int64))
        self._seg.append(np.asarray(seg_ids, dtype=np.int64))
        self._mask.append(np.asarray(mask, dtype=np.bool_))
        self._times.append(np.asarray(times_ns, dtype=np.int64))
        if sids is None:
            self._sids.append(None)
        elif np.isscalar(sids):
            self._sids.append(
                np.full(len(self._vals[-1]), sids, dtype=np.int64))
        else:
            self._sids.append(np.asarray(sids, dtype=np.int64))
        self._bnds.append(
            None if boundaries is None
            else np.asarray(boundaries, dtype=np.int64))
        self.n += len(self._vals[-1])

    def layout_name(self) -> str:
        if self._state is not None:
            return "grid"
        if self._fallback is not None:
            return "grid->bucketed"
        return "grid (not executed)"

    def host_times(self) -> np.ndarray:
        return (np.concatenate(self._times) if self._times
                else np.empty(0, np.int64))

    def host_value_multiset(self, num_segments: int):
        """Rank aggregates never take the grid locally, but the cluster's
        merge (query/partials.py) may ask any batch for its multiset."""
        self._ensure_fallback()
        return self._fallback.host_value_multiset(num_segments)

    # -- freeze ----------------------------------------------------------

    def _ensure_fallback(self):
        if self._fallback is None:
            fb = ragged.BucketedBatch(self.dtype, self.device)
            for v, r, s, m, t in zip(self._vals, self._rel, self._seg,
                                     self._mask, self._times):
                fb.add(v, r, s, m, t)
            self._fallback = fb

    def _freeze(self, num_segments: int):
        """Returns the grid state dict, or None (delegate to bucketed)."""
        if self._state is not None or self._fallback is not None:
            return self._state
        state = self._try_grid(num_segments)
        if state is None:
            STATS.incr("executor", "grid_fallbacks")
            self._ensure_fallback()
        else:
            STATS.incr("executor", "grid_batches")
            self._state = state
        return self._state

    def _try_grid(self, num_segments: int):
        W = self.W
        if self.n == 0 or W < 1 or num_segments % W:
            return None
        if any(s is None for s in self._sids):
            return None  # no series identity: cannot prove no slot clash
        rel = np.concatenate(self._rel)
        seg = np.concatenate(self._seg)
        sid = np.concatenate(self._sids)
        n = len(rel)
        # series runs: sid change or chunk boundary (a run is only
        # required to be internally constant-stride)
        boundary = np.zeros(n, dtype=np.bool_)
        boundary[0] = True
        boundary[1:] = sid[1:] != sid[:-1]
        off = 0
        for v, b in zip(self._vals, self._bnds):
            if b is not None and len(b):
                boundary[off + b] = True  # coalesced-add record breaks
            off += len(v)
            if off < n:
                boundary[off] = True
        d = np.diff(rel)
        inner = ~boundary[1:]
        dd = d[inner]
        if len(dd) and int(dd.min()) <= 0:
            return None  # duplicate/unsorted times within a run
        # dt = gcd(all within-run diffs, window): every within-run diff is
        # a positive multiple of dt, so (window, (rel - w*every)//dt) is
        # injective per run
        dt = _stride_gcd(dd, self.every_ns) if len(dd) else self.every_ns
        if dt <= 0 or self.every_ns % dt:
            return None
        k = self.every_ns // dt
        if k > _MAX_K:
            return None
        bnd_idx = np.flatnonzero(boundary)
        S = len(bnd_idx)
        S_pad = _pad_rows(S, _MIN_S)
        W_pad = _pad_lanes(W, _MIN_W)
        mesh = self._mesh_for_rows(S_pad)
        if mesh is not None and S_pad % mesh.size:
            # pad the row axis to a mesh multiple up front: the grid
            # scatters straight into the splittable shape, and the device
            # tier's shape is the same for cold and warm scans
            S_pad += mesh.size - S_pad % mesh.size
        cells = S_pad * k * W_pad  # padded = what actually allocates
        if cells > _MAX_GRID_CELLS or cells > max(_MAX_EXPANSION * n, 1 << 20):
            return None
        w = seg % W
        r = (rel - w * self.every_ns) // dt
        if (r < 0).any() or (r >= k).any():
            return None  # window grid misaligned with the stride grid
        rid = np.cumsum(boundary) - 1
        flat = (rid * k + r) * W_pad + w
        shape = (S_pad, k, W_pad)
        # device tier consult: an identically signed earlier scan holds
        # the padded grid on the card — skip the host scatter, the
        # decode and the transfer (the signature embeds every shard's
        # data_version)
        dev_entry = None
        if self.device_cache_token is not None:
            dev_entry = colcache.GLOBAL.device_get(
                self.device_cache_token, shape=shape, dtype=str(self.dtype),
                mesh=mesh)
        enc_plan = arrays = host_s = None
        if dev_entry is None:
            enc_plan = self._encoded_plan(shape, flat, mesh, rel, bnd_idx,
                                          dt)
            if enc_plan is None:
                # the host route: its decode (through
                # _EncodedVals.__array__) and scatter wall; each launch
                # adds its own, so the planner's host samples cover the
                # span the fused device sample does
                t0 = time.perf_counter()
                arrays = self._scatter_grid(shape, flat)
                host_s = time.perf_counter() - t0
        run_gid = (seg[bnd_idx] // W).astype(np.int64)
        order = np.argsort(run_gid, kind="stable")
        sg = run_gid[order]
        gb = np.empty(S, dtype=np.bool_)
        gb[0] = True
        gb[1:] = sg[1:] != sg[:-1]
        starts = np.flatnonzero(gb)
        return {
            "k": k, "S": S, "W_pad": W_pad, "shape": shape,
            "arrays": arrays,
            "dev": (None if dev_entry is None
                    else (dev_entry["vt"], dev_entry["mt"])),
            # the layout "dev" has: its mesh (None: one device) and the
            # mesh epoch it was made under
            "dev_mesh": mesh, "dev_epoch": runtime.mesh_epoch(),
            # the selector index grid of that layout when no retained
            # entry holds it, and the layout's ledger row
            "imat_dev": None, "ledger": None,
            "device_entry": dev_entry,
            "encoded_plan": enc_plan, "flat_dev": None,
            "host_route_s": host_s,
            # the sample-index grid for the selector group builds lazily
            # from `flat` — count/sum/mean scans never pay for it
            "flat": flat, "n": n,
            "rel": rel,
            "row_order": order,  # grid rows sorted by gid
            "gid_starts": starts,  # reduceat starts in row_order
            "gids_present": sg[starts],
            "rows_per_gid": np.diff(np.append(starts, S)),
        }

    # -- execution -------------------------------------------------------

    supports_want_sel = True

    def run(self, spec, num_segments: int, params: tuple = (),
            want_sel: bool = True):
        """want_sel=False skips the selector index machinery for min/max
        (their values come from the basic kernel)."""
        st = self._freeze(num_segments)
        if st is None:
            return self._fallback.run(spec, num_segments, params,
                                      want_sel=want_sel)
        name = spec.name
        if name not in GRID_AGGS:
            self._ensure_fallback()
            return self._fallback.run(spec, num_segments, params,
                                      want_sel=want_sel)
        G = num_segments // self.W
        raw = self._raw_stats(
            need_ssd=(name == "stddev"),
            need_selectors=name in ("first", "last") or (
                want_sel and name in ("min", "max")),
        )
        order, starts = st["row_order"], st["gid_starts"]
        gids, W = st["gids_present"], self.W

        cnt_rows = raw["count"][order].astype(np.int64)
        cnt_g = np.add.reduceat(cnt_rows, starts, axis=0)
        counts = np.zeros(num_segments, dtype=np.int64)
        counts.reshape(G, W)[gids] = cnt_g

        out = np.zeros(num_segments, dtype=np.float64)
        out2d = out.reshape(G, W)
        sel = None
        if name == "count":
            out2d[gids] = cnt_g
        elif name == "sum":
            out2d[gids] = np.add.reduceat(raw["sum"][order], starts, axis=0)
        elif name == "mean":
            s = np.add.reduceat(raw["sum"][order], starts, axis=0)
            out2d[gids] = s / np.maximum(cnt_g, 1)
        elif name == "min":
            out2d[gids] = np.minimum.reduceat(raw["min"][order], starts, axis=0)
            if want_sel:
                sel = self._combine_value_selector(st, raw, "min", num_segments)
        elif name == "max":
            out2d[gids] = np.maximum.reduceat(raw["max"][order], starts, axis=0)
            if want_sel:
                sel = self._combine_value_selector(st, raw, "max", num_segments)
        elif name == "spread":
            mn = np.minimum.reduceat(raw["min"][order], starts, axis=0)
            mx = np.maximum.reduceat(raw["max"][order], starts, axis=0)
            out2d[gids] = mx - mn
        elif name == "stddev":
            s = np.add.reduceat(raw["sum"][order], starts, axis=0)
            mean_g = s / np.maximum(cnt_g, 1)
            # exact k-way variance combine across the gid's series rows:
            # SSD = sum_i [ssd_i + c_i (mu_i - mu)^2]
            mean_rep = np.repeat(mean_g, st["rows_per_gid"], axis=0)
            extra = cnt_rows * (raw["mean"][order] - mean_rep) ** 2
            ssd = np.add.reduceat(raw["ssd"][order] + extra, starts, axis=0)
            out2d[gids] = np.sqrt(
                np.maximum(ssd / np.maximum(cnt_g - 1, 1), 0))
        elif name in ("first", "last"):
            vals2d, sel = self._combine_time_selector(st, raw, name,
                                                      num_segments)
            out2d[gids] = vals2d
        return out, sel, counts

    def _encoded_plan(self, shape, flat, mesh, rel, starts, dt):
        """Fused device-decode plan for a fully-encoded cold scan, or
        None: every add must still carry its encoded blocks, the offload
        planner must route the scan to the device (or the mesh) and the
        decoder must accept every block. Under a mesh the plan is split
        by output row shard, so each shard decodes only its own rows'
        bytes. None means the freeze decodes and scatters on the
        host."""
        views = []
        any_decoded = False
        for v in self._vals:
            col = getattr(v, "col", None)
            if col is None:
                return None
            # a column the host tier already decoded keeps its encoded
            # blocks: the device route stays a candidate
            any_decoded |= col.is_decoded
            views.append((col.blocks, col.abs_segments(), col.n_full))
        # THE route of the encoded cold scan: the static prior is the
        # device on cold encoded columns and the host once they are
        # decoded, which a cold or disabled planner answers verbatim.
        # "host" skips the plan (a routing choice, not a decode
        # fallback)
        dev_route = "mesh" if mesh is not None else "device"
        static = "host" if any_decoded else dev_route
        geo = (tuple(shape), str(self.dtype))
        route = offload.GLOBAL.decide("grid_decode", geo,
                                      ("host", dev_route), static,
                                      stage="grid_decode")
        if route == "host" and not offload.wants_prewarm("grid_decode",
                                                         geo):
            return None
        mask = np.concatenate(self._mask)
        if mesh is not None:
            plan = device_decode.build_mesh_grid_plan(
                views, flat, mask, shape, self.dtype, mesh, rel=rel,
                starts=starts, every_ns=self.every_ns, dt=dt)
        else:
            plan = device_decode.build_grid_plan(
                views, flat, mask, shape, self.dtype, self.device, rel=rel,
                starts=starts, every_ns=self.every_ns, dt=dt)
        if route == "host":
            # flagged for pre-warming: hand the fused site's first run to
            # the background pre-warmer (the plan build is host work);
            # this query still scatters on the host
            if plan is not None:
                offload.register_builder("grid_decode", geo,
                                         device_decode.plan_builder(plan))
            return None
        if plan is None:
            STATS.incr("executor", "grid_decode_fallbacks")
        return plan

    def _scatter_grid(self, shape, flat):
        """Scatter the raw rows into the padded (S_pad, k, W_pad) grid on
        the host (encoded adds decode through _EncodedVals.__array__)."""
        vt = np.zeros(shape, dtype=self.dtype)
        mt = np.zeros(shape, dtype=np.bool_)
        vt.reshape(-1)[flat] = np.concatenate(self._vals)
        mt.reshape(-1)[flat] = np.concatenate(self._mask)
        return vt, mt

    @staticmethod
    def _mesh_for_rows(rows: int):
        """The configured mesh when ``rows`` grid rows can split over it,
        else None (one device, exactly as before)."""
        mesh = runtime.get_mesh()
        if mesh is None or rows < mesh.size:
            return None
        return mesh

    def _drop_layout(self) -> None:
        """Forget the device layout (a reload changed the mesh)."""
        st = self._state
        st["dev"] = None
        st["imat_dev"] = None
        devobs.LEDGER.drop(st["ledger"])
        st["ledger"] = None

    def _set_layout(self, vt, mt, mesh) -> None:
        """Adopt (vt, mt) as the batch's layout for `mesh`: retained in
        the device tier when the scan carries a signature, else the
        batch's own (a ledger row when sharded)."""
        st = self._state
        st["dev"] = (vt, mt)
        st["dev_mesh"] = mesh
        st["dev_epoch"] = runtime.mesh_epoch()
        if self.device_cache_token is not None:
            ent = colcache.GLOBAL.device_put_grid(
                self.device_cache_token, vt, mt, shape=st["shape"],
                dtype=str(self.dtype), mesh=mesh)
            st["device_entry"] = ent
            st["dev"] = (ent["vt"], ent["mt"])
        elif mesh is not None:
            st["ledger"] = devobs.LEDGER.register(
                "grid_mesh", vt.nbytes + mt.nbytes,
                mesh_epoch=st["dev_epoch"], label="grid", anchor=self)

    def _device_arrays(self):
        """(vt, mt) in the layout the current mesh asks for: Sharded row
        splits under a mesh, tensors on the batch's device otherwise. A
        layout made for another mesh is resharded in the device tier (a
        retained entry) or rebuilt from the batch's rows."""
        st = self._state
        mesh = self._mesh_for_rows(st["shape"][0])
        if st["dev"] is not None and (
                st["dev_mesh"] is not mesh
                or (mesh is not None
                    and st["dev_epoch"] != runtime.mesh_epoch())):
            self._drop_layout()
            if st["device_entry"] is not None:
                ent = colcache.GLOBAL.device_get(
                    self.device_cache_token, shape=st["shape"],
                    dtype=str(self.dtype), mesh=mesh)
                st["device_entry"] = ent
                if ent is not None:
                    st["dev"] = (ent["vt"], ent["mt"])
                    st["dev_mesh"] = mesh
                    st["dev_epoch"] = runtime.mesh_epoch()
        if st["dev"] is None:
            if st["arrays"] is None:
                # the layout of a device-tier hit or of a fused decode
                # was for another mesh and could not follow it: rebuild
                # the grid from the raw rows (encoded adds decode through
                # _EncodedVals.__array__)
                st["arrays"] = self._scatter_grid(st["shape"], st["flat"])
                st["encoded_plan"] = None
            vt, mt = st["arrays"]
            retain = self.device_cache_token is not None
            if mesh is not None:
                vt_d, mt_d = distributed.shard_leading_axis(
                    mesh, vt, mt,
                    xfer_site="colcache-fill" if retain else "grid-shard")
            else:
                vt_d = templates.to_device(vt, self.device)
                mt_d = templates.to_device(mt, self.device)
                if retain:
                    # a cold scan with the device tier on: this one
                    # transfer lands in the retained entry, which later
                    # kernel groups of this scan and identically signed
                    # scans reuse
                    devobs.note_transfer("h2d", "colcache-fill",
                                         vt.nbytes + mt.nbytes)
            self._set_layout(vt_d, mt_d, mesh)
        return st["dev"]

    def _device_imat(self) -> torch.Tensor:
        """The selector index grid in the current layout."""
        st = self._state
        self._device_arrays()
        ent = st["device_entry"]
        if ent is not None and ent["imat"] is not None:
            return ent["imat"]
        if st["imat_dev"] is not None:
            return st["imat_dev"]
        mesh = st["dev_mesh"]
        if st["flat_dev"] is not None and mesh is None:
            # the fused decode left its scatter slots on the card
            imat = device_decode.imat_from_flat(st["flat_dev"], st["shape"])
        else:
            imat_np = np.zeros(st["shape"], dtype=np.int32)
            imat_np.reshape(-1)[st["flat"]] = np.arange(st["n"],
                                                        dtype=np.int32)
            if mesh is not None:
                (imat,) = distributed.shard_leading_axis(
                    mesh, imat_np, xfer_site=(
                        "grid-shard" if ent is None else "colcache-fill"))
            else:
                imat = templates.to_device(imat_np, self.device)
        if ent is not None:
            return colcache.GLOBAL.device_add_imat(
                self.device_cache_token, ent, imat, mesh=mesh)
        st["imat_dev"] = imat
        if st["ledger"] is not None:
            devobs.LEDGER.update(st["ledger"], sum(
                distributed.nbytes_of(t) for t in (*st["dev"], imat)))
        return imat

    def _wall_now(self) -> float:
        """perf_counter once the card has finished the work queued so far,
        while the planner is on (its samples are whole walls, not launch
        walls; the fetch that follows waits for the card anyway)."""
        dev = torch.device(self.device)
        if offload.enabled() and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def _launch(self, kind: str) -> dict:
        st = self._state
        plan = st["encoded_plan"]
        geo = (st["shape"], str(self.dtype))
        if plan is not None:
            # fused cold path: encoded bytes -> card -> decode -> scatter
            # -> basic reduce (per shard under a mesh); the decoded grid
            # stays on the card for the ssd and selector groups (no
            # second transfer)
            mesh = getattr(plan, "mesh", None)
            t0 = time.perf_counter()
            if mesh is not None:
                stats, vt, mt, flat_d = device_decode.run_mesh_grid_plan(
                    plan)
            else:
                stats, vt, mt, flat_d = device_decode.run_grid_plan(plan)
            offload.GLOBAL.observe(
                "grid_decode", geo, "device" if mesh is None else "mesh",
                self._wall_now() - t0)
            st["encoded_plan"] = None
            st["flat_dev"] = flat_d
            self._set_layout(vt, mt, mesh)
            STATS.incr("executor", "grid_decode_fused")
            if kind == "basic":
                return stats
        tw = time.perf_counter()
        vt, mt = self._device_arrays()
        with devobs.first_run("grid_" + kind, geo, vt.device):
            if kind == "basic":
                out = _each_shard(cuda_segment.grid_window_agg, vt, mt)
            elif kind == "ssd":
                out = {"ssd": _each_shard(_grid_ssd, vt, mt)}
            else:
                out = _each_shard(_grid_selectors, vt, mt,
                                  self._device_imat())
        if st["arrays"] is not None or st["host_route_s"] is not None:
            # a host-route sample per kernel group: the first carries the
            # decode and scatter wall (freeze), each its own transfer and
            # launch; together the span the fused device sample covers
            base = st["host_route_s"]
            st["host_route_s"] = None
            offload.GLOBAL.observe("grid_decode", geo, "host",
                                   (base or 0.0) + (self._wall_now() - tw))
        return out

    def _raw_stats(self, need_ssd: bool, need_selectors: bool) -> dict:
        S = self._state["S"]

        def settle(kind):
            got = self._launch(kind)
            self._raw.update({k: distributed.fetch_np(t)[:S, : self.W]
                              for k, t in got.items()})

        if "count" not in self._raw:
            settle("basic")
        if need_ssd and "ssd" not in self._raw:
            settle("ssd")
        if need_selectors and "sel_first" not in self._raw:
            settle("selectors")
        return self._raw

    def _combine_value_selector(self, st, raw, name, num_segments):
        """Per-segment row index of the selected min/max point. Value ties
        break by earliest timestamp then row order — the BucketedBatch /
        ops/segment.py rule."""
        order, starts = st["row_order"], st["gid_starts"]
        gids = st["gids_present"]
        G = num_segments // self.W
        rel = st["rel"]
        S = st["S"]
        v = raw[name][order]
        red = np.minimum if name == "min" else np.maximum
        ext = red.reduceat(v, starts, axis=0)
        ext_rep = np.repeat(ext, st["rows_per_gid"], axis=0)
        cnt = raw["count"][order]
        sel_sub = raw["sel_" + name][order]
        hit = (v == ext_rep) & (cnt > 0)
        t = np.where(hit, rel[sel_sub], np.iinfo(np.int64).max)
        tbest = np.repeat(np.minimum.reduceat(t, starts, axis=0),
                          st["rows_per_gid"], axis=0)
        hit &= t == tbest
        rows = np.arange(S, dtype=np.int64)[:, None]
        idx = np.where(hit, rows, S)
        pick = np.clip(np.minimum.reduceat(idx, starts, axis=0), 0, S - 1)
        sel = np.zeros(num_segments, dtype=np.int64)
        # result[g, w] = sel_sub[pick[g, w], w] — rows align with gids order
        sel.reshape(G, self.W)[gids] = np.take_along_axis(sel_sub, pick, axis=0)
        return sel

    def _combine_time_selector(self, st, raw, name, num_segments):
        """first/last across a gid's series rows: pick by extreme exact
        timestamp (ties by row order). Returns (values for present gids,
        sel array)."""
        order, starts = st["row_order"], st["gid_starts"]
        gids = st["gids_present"]
        G = num_segments // self.W
        rel = st["rel"]
        S = st["S"]
        cnt = raw["count"][order]
        sel_sub = raw["sel_" + name][order]
        vals_sub = raw[name][order]
        latest = name == "last"
        bad = np.iinfo(np.int64).min if latest else np.iinfo(np.int64).max
        t = np.where(cnt > 0, rel[sel_sub], bad)
        red = np.maximum if latest else np.minimum
        tbest = np.repeat(red.reduceat(t, starts, axis=0),
                          st["rows_per_gid"], axis=0)
        hit = (cnt > 0) & (t == tbest)
        # exact-time ties across series rows: larger value wins
        # (reference FirstReduce/LastReduce tie rule)
        v_best = np.repeat(np.maximum.reduceat(
            np.where(hit, vals_sub, -np.inf), starts, axis=0),
            st["rows_per_gid"], axis=0)
        hit &= vals_sub == v_best
        rows = np.arange(S, dtype=np.int64)[:, None]
        if latest:
            # time ties pick the LATEST row in scan order — the
            # ops/segment.py `smax(idx)` rule for last()
            idx = np.where(hit, rows, -1)
            pick = np.clip(np.maximum.reduceat(idx, starts, axis=0), 0, S - 1)
        else:
            idx = np.where(hit, rows, S)
            pick = np.clip(np.minimum.reduceat(idx, starts, axis=0), 0, S - 1)
        vals2d = np.take_along_axis(vals_sub, pick, axis=0)
        sel = np.zeros(num_segments, dtype=np.int64)
        sel.reshape(G, self.W)[gids] = np.take_along_axis(sel_sub, pick, axis=0)
        return vals2d, sel


def _each_shard(fn, *args):
    """fn on the grid tensors, once per shard when they are Sharded."""
    if isinstance(args[0], distributed.Sharded):
        return distributed.per_shard(fn, *args)
    return fn(*args)


def _grid_ssd(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Two-pass squared deviations per (row, window) around the window
    mean (the one-pass formula cancels). Plain torch on the device: the
    JAX package runs this group as XLA, with no TPU kernel."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    vz = torch.where(m, v, zero)
    cnt = m.sum(dim=1)
    mean = vz.sum(dim=1) / cnt.clamp(min=1).to(v.dtype)
    dev = torch.where(m, v - mean[:, None, :], zero)
    return (dev * dev).sum(dim=1)


def _grid_selectors(v: torch.Tensor, m: torch.Tensor,
                    imat: torch.Tensor) -> dict:
    """Within-row sample selection for min/max/first/last (plain torch on
    the device, as the JAX package runs it in XLA). argmin/argmax ties take
    the lowest k index, the earliest in-row timestamp."""
    inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
    k = v.shape[1]
    mi = m.to(torch.uint8)
    r_min = torch.argmin(torch.where(m, v, inf), dim=1)
    r_max = torch.argmin(torch.where(m, -v, inf), dim=1)
    r_first = torch.argmax(mi, dim=1)
    r_last = (k - 1) - torch.argmax(torch.flip(mi, dims=(1,)), dim=1)

    def take(mat, ridx):
        return torch.gather(mat, 1, ridx[:, None, :])[:, 0, :]

    return {
        "sel_min": take(imat, r_min), "sel_max": take(imat, r_max),
        "sel_first": take(imat, r_first), "sel_last": take(imat, r_last),
        "first": take(v, r_first), "last": take(v, r_last),
    }


def _stride_gcd(dd: np.ndarray, every_ns: int) -> int:
    """gcd of every within-run time diff and the window length;
    constant-stride data exits via one vectorized modulo pass."""
    m = int(dd.min())
    if m <= 0:
        return 0
    if not (dd % m).any():  # every diff is a multiple of the smallest
        return int(np.gcd(m, every_ns))
    return int(np.gcd(np.gcd.reduce(np.unique(dd)), every_ns))


def _pow2_at_least(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _pad_lanes(n: int, floor: int) -> int:
    """Pad the lane (W) axis: the constant quantum below 256 lanes, then
    128-multiples to 2048, pow2 above (the JAX package's ladder)."""
    q = _LANE_QUANTUM
    if n <= floor:
        return floor
    if n <= 256:
        return (n + q - 1) // q * q
    if n <= 2048:
        return (n + 127) // 128 * 128
    return _pow2_at_least(n, 2048)


def _pad_rows(n: int, floor: int) -> int:
    """Pad the row (S) axis in 1.5x steps instead of 2x."""
    p = floor
    while p < n:
        p = (p * 3 + 1) // 2
        p = (p + 7) // 8 * 8
    return p
