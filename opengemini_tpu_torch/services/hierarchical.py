"""Hierarchical (tiered) storage service.

The port of ``opengemini_tpu/services/hierarchical.py``, whole; the
object-store tier is services/obstier.py with storage/objstore.py.

Reference: services/hierarchical/service.go:32-76 — warm shards move to
cold storage after an age threshold. Here: the shard directory moves to
the cold tier and a symlink keeps the hot path valid, so every code path
(readers, WAL, backup) continues to work unchanged. Object-store (OBS)
tiers plug in behind the same move operation in a later round.

Concurrency/failure contract:
  - writers take shard._lock, so WAL/index handles close safely under it;
  - READERS are lockless: old TSFReader objects are NOT closed — their
    fds stay valid across the rename (POSIX), and close on GC, matching
    storage/shard._retire_files;
  - any failure rolls the move back so the shard keeps serving.
"""

from __future__ import annotations

import os
import shutil
import time as _time

from opengemini_tpu_torch.services.base import Service, logger


class HierarchicalService(Service):
    name = "hierarchical"

    def __init__(self, engine, cold_dir: str, age_ns: int,
                 interval_s: float = 3600.0):
        super().__init__(interval_s)
        self.engine = engine
        self.cold_dir = os.path.abspath(cold_dir)
        self.age_ns = age_ns

    def handle(self, now_ns: int | None = None) -> int:
        if now_ns is None:
            now_ns = _time.time_ns()
        moved = 0
        for shard in self.engine.all_shards():
            try:
                if shard.tmax > now_ns - self.age_ns:
                    continue
                if os.path.islink(shard.path):
                    continue  # already cold
                moved += self._move(shard)
            except Exception:  # noqa: BLE001
                logger.exception("tiering of %s failed", shard.path)
        return moved

    def _move(self, shard) -> int:
        rel = os.path.relpath(shard.path, self.engine.root)
        cold_path = os.path.abspath(os.path.join(self.cold_dir, rel))
        os.makedirs(os.path.dirname(cold_path), exist_ok=True)
        # _flush_lock before _lock (shard lock-order rule; the flush
        # below re-enters the flush lock)
        with shard._flush_lock, shard._lock:
            shard.flush()
            # close WRITE handles only (writers are locked out by _lock);
            # reader objects stay open for lockless in-flight queries
            shard.wal.close()
            shard.index.close()
            moved = False
            try:
                shutil.move(shard.path, cold_path)
                moved = True
                os.symlink(cold_path, shard.path)
                self._reopen(shard)
            except BaseException:
                # roll back so the shard keeps serving from the hot tier
                try:
                    if moved and not os.path.exists(shard.path):
                        shutil.move(cold_path, shard.path)
                    elif moved:  # symlink created but reopen failed
                        os.unlink(shard.path)
                        shutil.move(cold_path, shard.path)
                finally:
                    self._reopen(shard)
                raise
        logger.info("moved shard %s to cold tier %s", rel, cold_path)
        return 1

    def _reopen(self, shard) -> None:
        from opengemini_tpu_torch.index.mergeset import open_series_index
        from opengemini_tpu_torch.storage.tsf import TSFReader
        from opengemini_tpu_torch.storage.wal import WAL

        shard.index = open_series_index(shard.path)
        shard.wal = WAL(os.path.join(shard.path, "wal.log"), sync=shard.wal.sync)
        # file-set swap: release the old readers' decoded-column cache
        # entries (their generations can never be hit again) and stamp
        # the fresh readers with the shard's cache namespace
        shard.drop_cached_columns()
        shard._files = [
            shard._adopt(TSFReader(os.path.join(shard.path, f)))
            for f in sorted(os.listdir(shard.path))
            if f.endswith(".tsf")
            and os.path.join(shard.path, f) not in shard._quarantined
        ]
