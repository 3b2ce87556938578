"""Deterministic disk/media-fault injection for the storage IO paths.

The port of ``opengemini_tpu/storage/diskfault.py``, whole. Rules keyed
by a path glob are consulted by every TSF block read and write, the TSF
trailer and meta reads and the meta write and fsync, the WAL appends,
fsyncs and replay reads, and the engine's meta.json save: the byte
chokepoints where real media corruption would enter.

Pass-through contract: with no rules armed every hook is one truthiness
check of an empty list, and the IO is bit-identical to unhooked IO.

A rule is one glob and one action. The glob is fnmatch'd against the
file's full path (``*`` crosses ``/``, so ``*.tsf`` matches every TSF
file). Actions (``eio`` applies to reads, writes and fsyncs):

  eio               raise DiskFault (an OSError: EIO from the media)
  short-read[:n]    return only the first n bytes of a read (default:
                    half the buffer)
  bitflip[:off]     flip one bit of the buffer at byte offset `off`
                    (default: the middle byte); reads and writes
  torn-write[:n]    persist only the first n bytes of a write (default:
                    half) and report success
  fsync-fail        raise DiskFault at the durability barrier

Any action may carry a ``#<k>`` suffix: fire only on the k-th matching
hit of that rule, counting otherwise.

Arming:

  env:      OGT_DISKFAULT="glob=action;glob2=action2"
  HTTP:     POST /debug/ctrl?mod=diskfault&path=...&action=...
            (action=off clears one rule; clear=1 heals all)

Every consult site carries a ``site=`` label; hit counts are kept per
(rule, site) (``hits()``).
"""

from __future__ import annotations

import fnmatch
import os

from opengemini_tpu_torch.utils import lockdep

_lock = lockdep.Lock()
# armed rules: (glob, action) — first applicable match wins, arming order
_rules: list[tuple[str, str]] = []
_hits: dict[str, int] = {}
# per-rule match counter driving the #k nth-hit gating
_counts: dict[tuple[str, str], int] = {}


class DiskFault(OSError):
    """Injected media fault (presents as an EIO from the device)."""


_READ_ACTIONS = ("eio", "short-read", "bitflip")
_WRITE_ACTIONS = ("eio", "torn-write", "bitflip")
_FSYNC_ACTIONS = ("eio", "fsync-fail")
_BY_OP = {"read": _READ_ACTIONS, "write": _WRITE_ACTIONS,
          "fsync": _FSYNC_ACTIONS}


def _split_nth(action: str) -> tuple[str, int | None]:
    base, _, nth = action.rpartition("#")
    if base and nth.isdigit():
        return base, int(nth)
    return action, None


def validate(action: str) -> None:
    """Reject malformed actions at arming time — a typo must fail the
    ctrl call, not silently pass IO through (or crash a later hook deep
    inside a flush)."""
    base, nth = _split_nth(action)
    if nth is not None and nth < 1:
        raise ValueError(f"bad diskfault nth-hit {nth}")
    if base in ("eio", "fsync-fail", "torn-write", "short-read", "bitflip"):
        return
    for prefix in ("short-read:", "torn-write:", "bitflip:"):
        if base.startswith(prefix):
            n = int(base.split(":", 1)[1])  # ValueError on garbage
            if n < 0:
                raise ValueError(f"bad diskfault offset/length {n}")
            return
    raise ValueError(f"unknown diskfault action {action!r}")


def _load_env() -> None:
    spec = os.environ.get("OGT_DISKFAULT", "")
    for part in spec.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        glob, _, action = part.rpartition("=")
        glob, action = glob.strip(), action.strip()
        if not glob:
            continue
        try:
            validate(action)
        except ValueError:
            continue
        _rules.append((glob, action))


_load_env()


def _forget_counts(path_glob: str) -> None:
    """Reset the glob's nth-hit counters (caller holds _lock): a
    re-armed `#k` rule must fire on its k-th hit again, not inherit a
    spent counter from its previous life."""
    for key in [k for k in _counts if k[0] == path_glob]:
        del _counts[key]


def set_rule(path_glob: str, action: str) -> None:
    validate(action)
    with _lock:
        _rules[:] = [r for r in _rules if r[0] != path_glob]
        _forget_counts(path_glob)
        _rules.append((path_glob, action))


def clear_rule(path_glob: str) -> bool:
    with _lock:
        before = len(_rules)
        _rules[:] = [r for r in _rules if r[0] != path_glob]
        _forget_counts(path_glob)
        return len(_rules) != before


def clear_all() -> None:
    with _lock:
        _rules.clear()
        _hits.clear()
        _counts.clear()


def rules() -> list[dict]:
    with _lock:
        return [{"path": g, "action": a} for g, a in _rules]


def hits() -> dict[str, int]:
    """Per (rule, site) fire counts: '<glob>=<action>@<site>' -> n."""
    with _lock:
        return dict(_hits)


def armed() -> bool:
    return bool(_rules)


def _match(op: str, path: str, site: str,
           only: tuple | None = None) -> str | None:
    """First rule whose glob matches `path` and whose action applies to
    `op`; returns the base action to APPLY (nth-gated) or None.  `only`
    narrows further to actions the CALLER can actually apply — a
    consult site with no buffer (check()) must not spend a
    data-transform rule's #k shot on a fault it cannot inject."""
    allowed = _BY_OP[op]
    with _lock:
        for glob, action in _rules:
            base, nth = _split_nth(action)
            kind = base.split(":", 1)[0]
            if kind not in allowed:
                continue
            if only is not None and kind not in only:
                continue
            if not fnmatch.fnmatch(path, glob):
                continue
            key = (glob, action)
            _counts[key] = _counts.get(key, 0) + 1
            if nth is not None and _counts[key] != nth:
                return None  # counted, not fired (failpoint #k semantics)
            hk = f"{glob}={action}@{site}"
            _hits[hk] = _hits.get(hk, 0) + 1
            return base
    return None


def _flip(buf: bytes, off: int) -> bytes:
    if not buf:
        return buf
    off = min(max(off, 0), len(buf) - 1)
    out = bytearray(buf)
    out[off] ^= 0x01
    return bytes(out)


def on_read(path: str, buf: bytes, site: str) -> bytes:
    """The read hook: returns `buf` (possibly corrupted) or raises."""
    if not _rules:  # fast path: nothing armed
        return buf
    action = _match("read", path, site)
    if action is None:
        return buf
    if action == "eio":
        raise DiskFault(f"diskfault: eio reading {path} [{site}]")
    if action.startswith("short-read"):
        n = (int(action.split(":", 1)[1]) if ":" in action
             else len(buf) // 2)
        return buf[:n]
    # bitflip[:off]
    off = int(action.split(":", 1)[1]) if ":" in action else len(buf) // 2
    return _flip(buf, off)


def on_write(path: str, buf: bytes, site: str) -> bytes:
    """The write hook: returns the bytes the MEDIA will actually hold
    (possibly torn/corrupted) or raises.  A torn/flipped write reports
    success to the caller — the corruption is discovered at read time,
    exactly like real silent media faults."""
    if not _rules:
        return buf
    action = _match("write", path, site)
    if action is None:
        return buf
    if action == "eio":
        raise DiskFault(f"diskfault: eio writing {path} [{site}]")
    if action.startswith("torn-write"):
        n = (int(action.split(":", 1)[1]) if ":" in action
             else len(buf) // 2)
        return buf[:n]
    off = int(action.split(":", 1)[1]) if ":" in action else len(buf) // 2
    return _flip(buf, off)


def on_fsync(path: str, site: str) -> None:
    if not _rules:
        return
    action = _match("fsync", path, site)
    if action is None:
        return
    raise DiskFault(f"diskfault: {action} fsyncing {path} [{site}]")


def check(op: str, path: str, site: str) -> None:
    """Raise-only consult for call sites with no single buffer (the
    engine meta.json save): applies eio/fsync-fail; data-transforming
    rules are never matched here (their hit counters stay untouched)."""
    if not _rules:
        return
    action = _match(op, path, site, only=("eio", "fsync-fail"))
    if action is not None:
        raise DiskFault(f"diskfault: {action} on {op} {path} [{site}]")
