"""Backup / restore tool.

Reference: lib/backup/backup.go (full + incremental cluster backup) and
app/ts-recover/recover/recover.go:51 (BackupRecover -> recoverData /
recoverMeta). Single-node scope this round:

  python -m opengemini_tpu_torch.tools.backup backup  -data DIR -out BACKUP [-since NS]
  python -m opengemini_tpu_torch.tools.backup restore -backup BACKUP -data DIR

Backup copies meta.json/users.json and every shard's immutable .tsf files
+ series.log (flush first via /debug/ctrl?mod=flush or Engine.flush_all
for a consistent snapshot; WALs of a live server are not copied — the
backup captures flushed state, like the reference's immutable-file
backups). Incremental (-since) copies only files modified after the given
unix-ns timestamp; restore overlays them (file names are monotonic per
shard, so replaying full + incrementals in order converges).

The port of ``opengemini_tpu/tools/backup.py``, whole, with its imports
rewritten.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time


def backup(data_dir: str, out_dir: str, since_ns: int = 0) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "created_ns": time.time_ns(),
        "since_ns": since_ns,
        "kind": "incremental" if since_ns else "full",
        "files": [],  # copied into this backup
        "all_files": [],  # full snapshot listing at backup time (for prune)
    }
    for name in ("meta.json", "users.json"):
        src = os.path.join(data_dir, name)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(out_dir, name))
            manifest["files"].append(name)
    data_root = os.path.join(data_dir, "data")
    if os.path.isdir(data_root):
        for root, _dirs, files in os.walk(data_root):
            rel_root = os.path.relpath(root, data_dir)
            for f in files:
                if not _is_backup_file(f, rel_root):
                    continue
                src = os.path.join(root, f)
                rel = os.path.join(rel_root, f)
                manifest["all_files"].append(rel)
                if since_ns and os.stat(src).st_mtime_ns <= since_ns:
                    continue
                dst = os.path.join(out_dir, rel_root, f)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)
                manifest["files"].append(rel)
    with open(os.path.join(out_dir, "MANIFEST.json"), "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=1)
    return manifest


def _is_backup_file(name: str, rel_root: str = "") -> bool:
    if name.endswith(".tsf") or name in ("series.log", "downsample.level"):
        return True
    # mergeset series index: immutable runs + its own crc-framed wal
    # (the SHARD wal stays excluded — backup is flush-first)
    in_idx = os.path.basename(rel_root) == "seriesidx"
    return in_idx and (name.endswith(".msi") or name == "wal.log")


def restore(backup_dir: str, data_dir: str) -> int:
    """Apply a backup. After copying, PRUNES data files absent from the
    manifest's snapshot listing — files deleted/compacted away between a
    full and an incremental backup must not be resurrected (their rows
    were deleted; the merge can't know that)."""
    with open(os.path.join(backup_dir, "MANIFEST.json"), encoding="utf-8") as fh:
        manifest = json.load(fh)
    os.makedirs(data_dir, exist_ok=True)
    n = 0
    for rel in manifest["files"]:
        src = os.path.join(backup_dir, rel)
        dst = os.path.join(data_dir, rel)
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        shutil.copy2(src, dst)
        n += 1
    keep = set(manifest.get("all_files", []))
    data_root = os.path.join(data_dir, "data")
    if keep and os.path.isdir(data_root):
        for root, _dirs, files in os.walk(data_root):
            rel_root = os.path.relpath(root, data_dir)
            for f in files:
                if _is_backup_file(f, rel_root) and os.path.join(rel_root, f) not in keep:
                    os.remove(os.path.join(root, f))
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ts-recover",
                                 description="opengemini-tpu backup/restore")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("backup")
    b.add_argument("-data", required=True)
    b.add_argument("-out", required=True)
    b.add_argument("-since", type=int, default=0, help="unix ns; incremental")
    r = sub.add_parser("restore")
    r.add_argument("-backup", required=True)
    r.add_argument("-data", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "backup":
        m = backup(args.data, args.out, args.since)
        print(f"{m['kind']} backup: {len(m['files'])} files -> {args.out}")
    else:
        n = restore(args.backup, args.data)
        print(f"restored {n} files -> {args.data}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
