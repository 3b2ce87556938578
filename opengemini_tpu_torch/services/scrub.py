"""Background integrity scrub: verify block CRCs, feed quarantine,
trigger replica repair.

The port of ``opengemini_tpu/services/scrub.py``, whole, with a plain
``threading`` lock. With a router at rf > 1, ``_repair`` pulls a
quarantined file's rows back from a replica through the router's
anti-entropy round.

The third leg of the media-fault tier (storage/diskfault.py injects,
TSF block CRCs detect, shard quarantine contains): latent corruption in
a cold file would otherwise sit undetected until a query happens to
decode the damaged block — possibly months later, after the last good
replica rotated away.  The scrub walks every shard's immutable files at
a byte-budgeted pace (Taurus, arXiv:2506.20010, treats storage-media
failure as a first-class repair-from-replica event; the reference's
analogue is the HA store's background verification), verifying each
block's CRC WITHOUT decoding or polluting caches.

On damage: the file is quarantined through the owning shard (durable
marker, out of the read set, counters + sherlock dump), and — when a
DataRouter with rf>1 is attached — an anti-entropy round is triggered
so the lost rows re-replicate from a healthy owner without operator
action: detect → quarantine → digest divergence → pull → LWW merge.

Governance: ticks ride ``Service._governed_tick`` like compaction, and
each tenant's scrubbed bytes are charged to its governor account the
way rollup folds are (`GOVERNOR.charge_tenant`), so scrub IO is
attributable per database and pauses under interactive saturation.

Knobs (env, config, /debug/ctrl?mod=scrub):
  OGT_SCRUB=0              disable entirely (service ticks are inert)
  OGT_SCRUB_INTERVAL_S     tick interval (default 30; config
                           scrub-interval-s)
  OGT_SCRUB_MB             per-tick byte budget (default 4; config
                           scrub-mb; ctrl mb=)
"""

from __future__ import annotations

import os
import threading
import time as _time

from opengemini_tpu_torch.services.base import Service, logger
from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS
from opengemini_tpu_torch.utils.stats import histogram as _histogram

# per-file verify latency (ogt_scrub_seconds at /metrics): how long one
# file's CRC sweep holds the background token
_H_SCRUB = _histogram("scrub_seconds")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def enabled_by_env() -> bool:
    return os.environ.get("OGT_SCRUB", "") != "0"


class ScrubService(Service):
    name = "scrub"
    governed = True

    def __init__(self, engine, interval_s: float | None = None,
                 router=None, mb_per_tick: int | None = None):
        if interval_s is None:
            interval_s = float(os.environ.get("OGT_SCRUB_INTERVAL_S",
                                              "") or 30.0)
        super().__init__(interval_s)
        self.engine = engine
        self.router = router  # rf>1: repair trigger (may be set later)
        self.mb_per_tick = (mb_per_tick if mb_per_tick is not None
                            else _env_int("OGT_SCRUB_MB", 4))
        self.enabled = enabled_by_env()
        # resume cursor: (file path, reader gen) -> next block index.
        # In-memory only — a restart re-scrubs from the front, which is
        # the safe direction for an integrity sweep.
        self._cursor: dict[tuple[str, int], int] = {}
        self._done: set[tuple[str, int]] = set()
        self.passes = 0
        # a ctrl op=tick racing the background service tick must not
        # interleave cursor/done mutations (regressed cursors, double
        # verification charged twice, double pass counts)
        self._tick_lock = lockdep.Lock()

    # -- one tick ----------------------------------------------------------

    def handle(self) -> int:
        """Verify up to the byte budget; returns bytes verified this
        tick.  Damage quarantines the file and (rf>1) triggers an
        anti-entropy repair round after the sweep.  Serialized: a ctrl
        op=tick and the background ticker share the cursor state."""
        if not self.enabled:
            return 0
        with self._tick_lock:
            return self._sweep()

    def _sweep(self) -> int:
        from opengemini_tpu_torch.storage.tsf import CorruptFile
        from opengemini_tpu_torch.utils import tracing
        from opengemini_tpu_torch.utils.governor import GOVERNOR

        t_tick = _time.perf_counter_ns()
        # float-tolerant (tests pace at sub-MB budgets)
        budget = int(self.mb_per_tick * (1 << 20))
        verified = 0
        quarantined = 0
        with self.engine._lock:
            shards = list(self.engine._shards.items())
        # enumerate the COMPLETE live set before verifying anything:
        # pass completion compares _done against every live file, so a
        # budget that runs dry mid-iteration cannot mistake a partial
        # sweep for a full pass (which would reset _done and starve the
        # shards later in the order forever)
        work: list = []
        live_keys: set[tuple[str, int]] = set()
        for (db, _rp, _start), sh in shards:
            with sh._lock:
                files = list(sh._files)
            for reader in files:
                live_keys.add((reader.path, reader.gen))
                work.append((db, sh, reader))
        for db, sh, reader in work:
            if budget <= 0 or self._stop.is_set():
                break
            key = (reader.path, reader.gen)
            if key in self._done:
                continue
            if not getattr(reader, "block_crc", False):
                # legacy revision-1 file: no seals to verify (its
                # meta CRC was checked at open) — count it done
                self._done.add(key)
                STATS.incr("scrub", "legacy_skipped_total")
                continue
            t0 = _time.perf_counter_ns()
            locs = reader.data_locs()
            idx = self._cursor.get(key, 0)
            n = 0
            try:
                while idx < len(locs) and budget > 0:
                    n += reader.verify_block(locs[idx])
                    budget -= locs[idx][1]
                    idx += 1
            except CorruptFile as e:
                quarantined += 1
                STATS.incr("scrub", "corruptions_found_total")
                logger.error("scrub: %s", e)
                sh.quarantine_file(e.path, e.why)
                self._cursor.pop(key, None)
                self._done.add(key)  # out of the read set now
            except OSError:
                # file retired under us mid-sweep: not damage
                self._cursor.pop(key, None)
                self._done.add(key)
            else:
                if idx >= len(locs):
                    self._cursor.pop(key, None)
                    self._done.add(key)
                    STATS.incr("scrub", "files_verified_total")
                else:
                    self._cursor[key] = idx
            verified += n
            if n:
                GOVERNOR.charge_tenant(db, "scrub_bytes", n)
            _H_SCRUB.observe_ns(_time.perf_counter_ns() - t0)
            if budget <= 0 or self._stop.is_set():
                break
        # forget retired files; a full pass over everything live resets
        # the done-set so the sweep is continuous
        self._done &= live_keys
        self._cursor = {k: v for k, v in self._cursor.items()
                        if k in live_keys}
        if live_keys and self._done >= live_keys and not self._cursor:
            self._done.clear()
            self.passes += 1
            STATS.incr("scrub", "passes_total")
        STATS.incr("scrub", "bytes_total", verified)
        tracing.record_stage("scrub", _time.perf_counter_ns() - t_tick)
        if quarantined:
            self._repair()
        return verified

    def _repair(self) -> None:
        """rf>1 self-heal: pull the quarantined data back from a healthy
        replica through the anti-entropy digest/pull path."""
        router = self.router
        if router is None or getattr(router, "rf", 1) <= 1:
            return
        try:
            n = router.anti_entropy_round()
        except Exception:  # noqa: BLE001 — repair is retried next round
            logger.exception("scrub: repair round failed")
            return
        STATS.incr("scrub", "repairs_triggered_total")
        if n:
            STATS.incr("scrub", "repaired_divergences_total", n)
            logger.warning(
                "scrub: repaired %d diverged (group, measurement) pairs "
                "after quarantine", n)

    # -- introspection / ctrl ----------------------------------------------

    def tick_now(self) -> int:
        """One synchronous sweep (ctrl op=tick, tests, torture verify);
        ungated like Service.tick — manual triggers express intent."""
        return self.handle()

    def status(self) -> dict:
        return {
            "enabled": self.enabled,
            "interval_s": self.interval_s,
            "mb_per_tick": self.mb_per_tick,
            "passes": self.passes,
            "in_progress_files": len(self._cursor),
            "done_files": len(self._done),
            "counters": STATS.counters("scrub"),
        }
